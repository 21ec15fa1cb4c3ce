"""Continuous-batching serve engine over the zoo's prefill/decode steps.

The reference's slot model: one decode step over a fixed (n_slots,
cache_len) KV cache; requests map onto free slots, finished slots are
recycled mid-flight, and prefill runs on a fixed prompt block whose K/V rows
are copied into the slot cache. Every decode tick runs all slots, free ones
included (at length 0, attending one row), as the reference does.

Greedy decoding; per-request max_new_tokens and eos termination. The engine
is synchronous (``step()`` advances one decode tick). Prompts are
left-padded with token 0 to ``prefill_len`` at positions 0..P-1 and the pad
tokens are attended, exactly as in the reference. The caches live on
``device`` (the card unless ``device="cpu"``), beside the parameters, and
each decode tick writes its K/V rows into them in place: the counterpart of
the reference's ``donate_argnums`` on its jitted decode step.

On the card the decode tick is one CUDA graph per engine (the reference
jits it): captured on the first tick, after one eager warm-up tick on a
side stream (:func:`repro_torch.exec.capture.record`), and replayed on every
tick after. The graph reads the tokens and lengths from static buffers the
engine fills before each replay, writes the caches in place and takes the
argmax itself, so only the tokens come back to the host. A graph cannot
read the lengths back to check them, so the engine checks its host copy
before each replay instead. Prefill runs eagerly.
:func:`repro_torch.exec.capture.disabled` runs the tick eagerly too.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.models.zoo import _dtype


# why each family the engine does not drive is refused
_REFUSED = {
    "vlm": ("refused: its prefill takes the image's patch embeddings (batch['patches']) "
            "beside the tokens, and requests carry tokens only (the reference's engine "
            "admits the family, but its first prefill raises KeyError: 'patches')"),
    "encdec": ("refused, as by the reference's engine: its prefill takes the audio's "
               "frame embeddings (batch['frames']) and its decode a cross cache beside "
               "the slots' K/V"),
    "ssm": ("refused, as by the reference's engine: its caches are recurrent state, not "
            "K/V slots"),
    "hybrid": ("refused, as by the reference's engine: its caches are recurrent state and "
               "a ring of window rows, not K/V slots"),
}


@dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    rid: int = 0
    # filled by the engine
    output: list[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, params, *, n_slots: int = 4, cache_len: int = 256,
                 device=None):
        if model.cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"ServeEngine drives the dense and moe decoder LMs; {model.cfg.name} "
                f"({model.cfg.family}) is {_REFUSED[model.cfg.family]}. Drive it "
                "through build_model → init → prefill → decode"
            )
        self.device = resolve_device(device)
        leaf = params["embed"]
        if leaf.device != self.device:
            raise ValueError(f"parameters on {leaf.device}, engine on {self.device}")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.cache_len = cache_len
        cfg = model.cfg
        Ld, KH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        shape = (Ld, n_slots, cache_len, KH, hd)
        self.k_cache = torch.zeros(shape, dtype=_dtype(cfg), device=self.device)
        self.v_cache = torch.zeros_like(self.k_cache)
        self.lengths = np.zeros((n_slots,), np.int32)
        self.last_token = np.zeros((n_slots,), np.int32)
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self._rid = itertools.count()
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.prefill_len = 32  # fixed prompt block (pad/truncate to this)
        # the captured decode tick (on the card): its graph, static inputs
        # and output, the launches one replay makes, and its memory
        self._graph = None
        self._static: tuple = ()
        self._launches: dict[str, int] = {}
        self.captures = 0  # decode ticks captured (each ran once eagerly first)
        self.replays = 0
        self.graph_bytes = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)  # a copy, never a view of `a`

    # -- request lifecycle --------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> Request:
        r = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                    eos_id=eos_id, rid=next(self._rid))
        self.queue.append(r)
        return r

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    @torch.no_grad()
    def _admit(self) -> None:
        """Prefill queued requests into free slots (batched to n_slots)."""
        free = self._free_slots()
        take = min(len(free), len(self.queue))
        if take == 0:
            return
        reqs = [self.queue.pop(0) for _ in range(take)]
        P = self.prefill_len
        toks = np.zeros((take, P), np.int32)
        for i, r in enumerate(reqs):
            p = r.prompt[-P:]
            toks[i, P - len(p):] = p  # left-pad (positions still 0..P-1)
        logits, (kcs, vcs) = self.model.prefill(
            self.params, {"tokens": self._tensor(toks)}, cache_len=self.cache_len
        )
        first = logits.argmax(-1).to(torch.int32).cpu().numpy()
        slots = free[:take]
        self.k_cache[:, slots] = kcs
        self.v_cache[:, slots] = vcs
        for i, r in enumerate(reqs):
            s = slots[i]
            self.slot_req[s] = r
            self.lengths[s] = P
            tok = int(first[i])
            r.output.append(tok)
            self.last_token[s] = tok
            self._maybe_finish(s)

    def _maybe_finish(self, slot: int) -> None:
        r = self.slot_req[slot]
        if r is None:
            return
        if (
            len(r.output) >= r.max_new_tokens
            or (r.eos_id is not None and r.output and r.output[-1] == r.eos_id)
            or self.lengths[slot] + 1 >= self.cache_len
        ):
            r.done = True
            self.finished.append(r)
            self.slot_req[slot] = None
            self.lengths[slot] = 0

    # -- main loop -----------------------------------------------------------

    @torch.no_grad()
    def step(self) -> int:
        """Admit + one decode tick. Returns number of active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        tok = self._tick()
        for s in active:
            self.lengths[s] += 1
            t = int(tok[s])
            self.slot_req[s].output.append(t)
            self.last_token[s] = t
            self._maybe_finish(s)
        return len(active)

    def _decode(self, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """One decode step over all slots: the next token of each, on the
        card (the K/V rows written into the caches in place)."""
        logits, _ = self.model.decode(
            self.params, {"tokens": tokens, "lengths": lengths},
            (self.k_cache, self.v_cache),
        )
        return logits.argmax(-1).to(torch.int32)

    def _tick(self) -> np.ndarray:
        """One decode tick: eager on the CPU (and under
        ``capture.disabled()``), a graph replay on the card."""
        from repro_torch.exec import capture

        if self.device.type != "cuda" or not capture.enabled():
            return self._decode(self._tensor(self.last_token),
                                self._tensor(self.lengths)).cpu().numpy()
        # the check decode_attention cannot make inside a graph: every
        # slot attends its rows and the new one, within the cache
        lo, hi = int(self.lengths.min()), int(self.lengths.max())
        if lo < 0 or hi + 1 > self.cache_len:
            raise ValueError(f"decode tick: lengths span [{lo}, {hi}], must lie in "
                             f"[0, {self.cache_len - 1}]")
        if self._graph is None:
            from repro_torch.kernels.attention import lengths_checked

            tokens, lengths = self._tensor(self.last_token), self._tensor(self.lengths)

            def tick():
                with lengths_checked():
                    return self._decode(tokens, lengths)

            self._graph, out, self._launches, pool = capture.record(tick, self.device)
            self._static = (tokens, lengths, out)
            self.graph_bytes = pool + tokens.nbytes + lengths.nbytes
            self.captures += 1
        else:
            tokens, lengths, _ = self._static
            tokens.copy_(torch.from_numpy(self.last_token))
            lengths.copy_(torch.from_numpy(self.lengths))
        self._graph.replay()
        self.replays += 1
        for name, n in self._launches.items():
            _build.launched(name, n)
        return self._static[2].cpu().numpy()

    def run(self, max_ticks: int = 10_000) -> list[Request]:
        for _ in range(max_ticks):
            active = self.step()
            if active == 0 and not self.queue:
                break
        return self.finished
