"""Model zoo: the decoder LMs of the reference's zoo (dense and moe), on
PyTorch.

Every model exposes the reference's surface for serving:

  shapes   — nested dict of param shapes (per-leaf dtype via cfg.dtype)
  init     — draw the parameters on the device from a seeded generator
  prefill  — full-prompt forward → (last logits, caches)
  decode   — one-token step over caches → (logits, caches)

``build_model`` builds the ``dense`` and ``moe`` families. The ``vlm``,
``encdec``, ``ssm`` and ``hybrid`` families, and training (``loss``), are
ROADMAP Queue 1 item 10 and raise until they are ported.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import (
    decoder_decode_step,
    decoder_layer_shapes,
    decoder_prefill,
    embed_lookup,
    stack_shapes,
)

_NORMS = ("ln1", "ln2", "final_norm")  # initialised to ones


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _vp(cfg: ArchConfig) -> int:
    """Vocab padded to a mesh-divisible multiple (MaxText-style)."""
    return ((cfg.vocab_size + 255) // 256) * 256


def _head(h, params, cfg):
    """LM head with padded-vocab masking. h: (..., D) -> (..., Vp)."""
    z = h @ params["out_embed"]
    V, Vp = cfg.vocab_size, params["out_embed"].shape[1]
    if Vp > V:
        z[..., V:] = -1e30
    return z


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


class Model(nn.Module):
    """A decoder LM. Its parameters are a nested dict of tensors in the
    reference's layout (stacked per-layer leaves under ``layers``); after
    :meth:`init` the module holds them, one frozen ``nn.Parameter`` a leaf
    keyed by its path (``layers/attn/wq_col``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self.shapes = _lm_shapes(cfg)
        self.leaves = nn.ParameterDict()

    def init(self, generator: torch.Generator, device=None, dtype=None) -> dict:
        """Draw every leaf on ``device`` (the card unless asked otherwise)
        from ``generator``, which must live there: norms are ones, the rest
        normal with the reference's scale, 0.02 or 1/sqrt(fan_in) if that is
        smaller, cast to ``dtype`` (the config's by default). Stacked leaves
        are drawn a layer at a time, so no float32 copy of a whole leaf is
        made. Returns the nested parameter dict."""
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(
                f"init draws on {dev}: pass a torch.Generator made there, "
                f"not on {generator.device}"
            )
        dt = dtype or _dtype(self.cfg)
        for path, shape in _leaves(self.shapes):
            name = path.split("/")[-1]
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 0.02 if len(shape) < 2 else min(0.02, (1.0 / fan_in) ** 0.5)
            if name in _NORMS:
                leaf = torch.ones(shape, dtype=dt, device=dev)
            else:
                leaf = torch.empty(shape, dtype=dt, device=dev)
                parts = leaf if path.startswith("layers/") else leaf[None]
                for part in parts:
                    draw = torch.randn(part.shape, generator=generator,
                                       dtype=torch.float32, device=dev)
                    part.copy_(draw * scale)
            self.leaves[path] = nn.Parameter(leaf, requires_grad=False)
        return self.params()

    def params(self) -> dict:
        """The held leaves as the nested parameter dict (no copies)."""
        return _nest({k: v.data for k, v in self.leaves.items()})

    def prefill(self, params: dict, batch: dict, cache_len: int | None = None):
        return _lm_prefill(params, batch, self.cfg, cache_len=cache_len)

    def decode(self, params: dict, batch: dict, caches: tuple):
        return _lm_decode(params, batch, caches, self.cfg)


# ---------------------------------------------------------------------------
# Decoder-LM families (dense, moe)
# ---------------------------------------------------------------------------


def _lm_shapes(cfg: ArchConfig) -> dict:
    return {
        "embed": (_vp(cfg), cfg.d_model),
        "out_embed": (cfg.d_model, _vp(cfg)),
        "final_norm": (cfg.d_model,),
        "layers": stack_shapes(decoder_layer_shapes(cfg), cfg.n_layers),
    }


def _lm_embed_inputs(params, batch, cfg):
    return embed_lookup(params["embed"], batch["tokens"]).to(_dtype(cfg))


def _lm_prefill(params, batch, cfg: ArchConfig, cache_len=None):
    h = _lm_embed_inputs(params, batch, cfg)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    h, caches = decoder_prefill(
        params["layers"], h, cfg, positions=positions, cache_len=cache_len or S,
        window=cfg.sliding_window,
    )
    h = L.rmsnorm(h[:, -1], params["final_norm"], cfg.norm_eps)
    return _head(h, params, cfg), caches


def _lm_decode(params, batch, caches, cfg: ArchConfig):
    tokens, lengths = batch["tokens"], batch["lengths"]
    h = embed_lookup(params["embed"], tokens[:, None])[:, 0].to(_dtype(cfg))
    h, caches = decoder_decode_step(
        params["layers"], h, caches, lengths, cfg, window=cfg.sliding_window
    )
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _head(h, params, cfg), caches


# ---------------------------------------------------------------------------
# build_model dispatch
# ---------------------------------------------------------------------------

_NOT_PORTED = {
    "vlm": "the vlm family (vision projector)",
    "encdec": "the encdec family (whisper)",
    "ssm": "the ssm family (xlstm)",
    "hybrid": "the hybrid family (zamba2, with its sliding window)",
}


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in ("dense", "moe"):
        return Model(cfg)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: {_NOT_PORTED[cfg.family]} is not ported yet "
            "(ROADMAP Queue 1 item 10)"
        )
    raise ValueError(cfg.family)
