"""Two probes of ``attention_train``'s backward on one NVIDIA card, with
``chip_smoke.py``'s helpers and shapes:

    python3 tools/attention_train_probe.py time      # what the running max's gradient costs
    python3 tools/attention_train_probe.py whisper OUT_DIR   # the bf16 cross gradient after training

``time``: training steps of qwen2-0.5b (16 x 4,096, as ``chip_smoke.py``
trains it) and of zamba2-7b at 13 layers (8 x 4,096) with the online
softmax's running max held constant in the backward (``held``), its
gradient taken through ``amax`` over the score block (``amax``), through
the argmax key found in the forward (``argmax_fwd``: torch's ``max`` with
indices, in the forward and again in the recompute) and found in the
backward (``port``, the port's ``_kv_step``): two steps held as a warm-up,
then two timed steps of each in the order held, port, amax, argmax_fwd,
argmax_fwd, amax, port, held.

``whisper``: whisper-small trained 4 steps as ``chip_smoke.py`` trains
it, then one step's gradient in bf16 against float32 by leaf at its
check batch (2 clips, 1,500 frames, S = 448), with ``attention_train``
(A), a plain softmax attention on the same rounding points (B: scores and
sums in float32, P rounded to v's type in the product) and
``attention_train`` on float32 inputs (C); then the decoder layer whose
slice of the cross query's weight errs most under A has its cross
attention's inputs and output gradient dumped, in both steps, into
``OUT_DIR`` for ``tools/whisper_cross_backward.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

CROSS_QK = ("layers/ln_x", "layers/xattn/wq_col", "layers/xattn/bq_col",
            "layers/xattn/wk_col", "layers/xattn/bk_col")


def _scores(qb, kb, q_pos, k_pos, Skv, causal, window, masked):
    from repro_torch.models import layers as L

    s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), kb.float())
    if masked:
        ok = L._mask(q_pos, k_pos, causal, window) & (k_pos < Skv)[None, :]
        s = torch.where(ok, s, L.NEG_INF)
    return s


def _finish(m, l, acc, s, m_new, vb):
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
    return m_new, l_new, acc * alpha[..., None] + pv


def held_step(m, l, acc, qb, kb, vb, q_pos, k_pos, Skv, causal, window, masked):
    """The KV step with the running max held constant in the backward."""
    s = _scores(qb, kb, q_pos, k_pos, Skv, causal, window, masked)
    return _finish(m, l, acc, s, torch.maximum(m, s.detach().amax(dim=-1)), vb)


def amax_step(m, l, acc, qb, kb, vb, q_pos, k_pos, Skv, causal, window, masked):
    """The KV step with the running max's gradient through ``amax``."""
    s = _scores(qb, kb, q_pos, k_pos, Skv, causal, window, masked)
    return _finish(m, l, acc, s, torch.maximum(m, s.amax(dim=-1)), vb)


def argmax_fwd_step(m, l, acc, qb, kb, vb, q_pos, k_pos, Skv, causal, window, masked):
    """The KV step with the running max's gradient through the argmax key
    found in the forward: zero in value, q . k at that key in gradient."""
    from repro_torch.models import layers as L

    qf, kf = qb.float(), kb.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    ok = None
    if masked:
        ok = L._mask(q_pos, k_pos, causal, window) & (k_pos < Skv)[None, :]
        s = torch.where(ok, s, L.NEG_INF)
    top, at = s.detach().max(dim=-1)
    B, cq, KH, G, D = qf.shape
    idx = at.reshape(B, KH, G * cq, 1).expand(-1, -1, -1, D)
    k_at = kf.permute(0, 2, 1, 3).gather(2, idx).reshape(B, KH, G, cq, D)
    s_at = (qf.permute(0, 2, 3, 1, 4) * k_at).sum(dim=-1)
    delta = s_at - s_at.detach()
    if ok is not None:
        delta = delta * ok.any(dim=-1)
    return _finish(m, l, acc, s, torch.maximum(m, top + delta), vb)


def time_steps(cfg, B: int, S: int, lr: float, dev) -> dict[str, list[float]]:
    """Seconds of each timed training step of ``cfg`` at B x S, by variant."""
    from repro_torch.data.loader import TokenLoader
    from repro_torch.launch.train import choose_accum_steps
    from repro_torch.models import build_model, layers
    from repro_torch.train.step import init_opt_state, make_train_step

    port = layers._kv_step
    variants = {"held": held_step, "amax": amax_step, "argmax_fwd": argmax_fwd_step,
                "port": port}
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(cs.TRAIN_SEED), device=dev)
    opt = init_opt_state(model, params)
    accum = choose_accum_steps(cfg, B, S, dev)
    step_fn = make_train_step(model, lr=lr, accum_steps=accum)
    np_batch = TokenLoader(global_batch=B, seq_len=S, vocab=cfg.vocab_size,
                           seed=cs.TRAIN_SEED).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
    times: dict[str, list[float]] = {k: [] for k in variants}
    try:
        for i, name in enumerate(["held", "held", "port", "amax", "argmax_fwd", "argmax_fwd",
                                  "amax", "port", "held"]):
            layers._kv_step = variants[name]
            for _ in range(2):
                t0 = time.perf_counter()
                params, opt, metrics = step_fn(params, opt, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                if i:  # the first is the warm-up
                    times[name].append(dt)
                print(f"{cfg.name} ({accum} microbatches): {name} step {dt:.3f} s, "
                      f"loss {loss:.4f}", flush=True)
    finally:
        layers._kv_step = port
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return times


def probe_time(dev) -> dict:
    from repro_torch.configs import get_config

    out = {}
    qwen = get_config(cs.TRAIN_ARCH)
    out[cs.TRAIN_ARCH] = time_steps(qwen, cs.TRAIN_BATCH, cs.TRAIN_SEQ, cs.TRAIN_LR, dev)
    B, S, lr, cut = cs.REC_TRAIN[cs.ZAMBA_ARCH]
    zamba = dataclasses.replace(get_config(cs.ZAMBA_ARCH), **cut)
    out[cs.ZAMBA_ARCH] = time_steps(zamba, B, S, lr, dev)
    return {arch: {name: {"steps_s": t, "median_s": float(np.median(t))}
                   for name, t in times.items()} for arch, times in out.items()}


def plain_attention(q, k, v, *, causal=True, window=0, scale=None, **_):
    """Softmax attention over every key at once, on attention_train's
    rounding points: the query scaled and rounded to k's type, scores and
    sums in float32, P rounded to v's type in the product."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    scale = scale or 1.0 / D ** 0.5
    qs = (q.float() * scale).to(k.dtype).float().reshape(B, Sq, KH, H // KH, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, k.float())
    if causal or window:
        qp = torch.arange(Sq, device=q.device)[:, None] + Skv - Sq
        kp = torch.arange(Skv, device=q.device)[None, :]
        ok = (kp <= qp) if causal else torch.ones_like(kp <= qp)
        if window:
            ok = ok & (kp > qp - window)
        s = s.masked_fill(~ok, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def probe_whisper(dev, out_dir: Path) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data.loader import TokenLoader
    from repro_torch.models import layers as L

    cfg = get_config(cs.WHISPER_ARCH)
    B = cs.WHISPER_TRAIN[0]
    run = cs.drive_train(cfg, dev, cs.WHISPER_TRAIN, 0, tempfile.mkdtemp(), 0,
                         extra=lambda step: cs.whisper_frames(cfg, step, B, dev))
    params, losses = run["params"], run["losses"]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    Bc, S = cs.WHISPER_TRAIN_CHECK_BATCH, cs.WHISPER_TRAIN[1]
    np_batch = TokenLoader(global_batch=Bc, seq_len=S, vocab=cfg.vocab_size,
                           seed=cs.TRAIN_SEED).batch(100)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
    batch.update(cs.whisper_frames(cfg, 100, Bc, dev))
    _, g32 = cs.step_grads(dataclasses.replace(cfg, dtype="float32"), params, batch)
    beside = torch.linalg.vector_norm(g32["layers/xattn/wv_col"])
    out = {"losses": losses, "f32_norm_over_wv_col": {
        k: float(torch.linalg.vector_norm(g32[k]) / beside) for k in CROSS_QK}}
    real = L.attention_train

    def upcast(q, k, v, **kw):
        return real(q.float(), k.float(), v.float(), **kw).to(q.dtype)

    for name, attend in [("A attention_train", real), ("B plain softmax", plain_attention),
                         ("C attention_train on float32 inputs", upcast)]:
        L.attention_train = attend
        try:
            _, g16 = cs.step_grads(cfg, params, batch)
        finally:
            L.attention_train = real
        errs = cs.rel_errors(g16, g32)
        out[name] = {"cross_qk": {k: errs[k] for k in CROSS_QK},
                     "others_max": max(e for k, e in errs.items() if k not in CROSS_QK)}
        if attend is real:  # each decoder layer's slice of the cross query's weight
            leaf = "layers/xattn/wq_col"
            out[name]["wq_col_by_layer"] = [
                float(torch.linalg.vector_norm(g16[leaf][i].float() - g32[leaf][i])
                      / torch.linalg.vector_norm(g32[leaf][i])) for i in range(cfg.n_layers)]
        del g16
        print(name, json.dumps(out[name]), flush=True)
    by_layer = out["A attention_train"]["wq_col_by_layer"]
    out["dump"] = dump_cross(cfg, params, batch, int(np.argmax(by_layer)), out_dir)
    return out


def dump_cross(cfg, params, batch, layer: int, out_dir: Path) -> str:
    """One decoder layer's cross attention at this state, in the bf16 step
    and in the float32 step (the first clip; the attention is per clip): its
    query, keys, values, output gradient and the inputs of its projections
    (the ln_x output ``hn`` and the encoder's output), into
    ``out_dir/whisper_cross_layer<layer>.npz`` (bf16 as its uint16 bits),
    for ``tools/whisper_cross_backward.py`` to run both packages' chunked
    backward on. The layer runs unchanged but for the hook; remat is off,
    so the hooked output is the one the backward flows through."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    real = T._cross_attention
    dump = {}
    for dtype in ("bfloat16", "float32"):
        calls, seen = [0], {}

        def spy(p, hn, enc_out, c, seen=seen):
            i, calls[0] = calls[0], calls[0] + 1
            if i != layer:
                return real(p, hn, enc_out, c)
            B, S, _ = hn.shape
            xk, xv = L.attn_proj_kv(p, enc_out, c)
            q = T._train_cross_query(p, hn, c)
            att = L.attention_train(q, xk, xv, causal=False)
            att.register_hook(lambda g: seen.__setitem__("dO", g.detach()[:1].clone()))
            seen.update({n: t.detach()[:1].clone() for n, t in
                         (("q", q), ("k", xk), ("v", xv), ("hn", hn), ("enc", enc_out))})
            return att.reshape(B, S, c.n_heads * c.hd) @ p["wo_row"]

        T._cross_attention = spy
        try:
            cs.step_grads(dataclasses.replace(cfg, dtype=dtype, remat=False), params, batch)
        finally:
            T._cross_attention = real
        for n, t in seen.items():
            a = t.cpu()
            dump[f"{n}_{dtype}"] = (a.view(torch.int16).numpy().view(np.uint16)
                                    if a.dtype == torch.bfloat16 else a.numpy())
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"whisper_cross_layer{layer}.npz"
    np.savez(path, layer=np.int32(layer), **dump)
    print(f"dumped layer {layer}'s cross attention to {path} "
          f"({path.stat().st_size / 2**20:.1f} MiB)", flush=True)
    return str(path)


def main() -> int:
    args = sys.argv[1:]
    usage = args == ["time"] or (len(args) == 2 and args[0] == "whisper")
    if not torch.cuda.is_available() or not usage:
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = probe_time(dev) if args[0] == "time" else probe_whisper(dev, Path(args[1]))
    print(f"{sys.argv[1]} [{smi}]: {json.dumps(result)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
