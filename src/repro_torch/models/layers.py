"""Core layers of the LM zoo: norms, RoPE, attention, MLPs, embeddings.

The reference package's layers, on the same layouts: activations (B,S,D),
heads (B,S,H,D), caches (B,S,KH,D), weights (in, out) under leaf names that
carry the reference's sharding convention (``*_col``, ``*_row``). bf16 is
rounded where the reference rounds it: ``rmsnorm`` normalises in float32,
casts, then scales by the weight in the storage type; ``rope`` computes in
float32 and casts back; the MLP's activation runs in float32.

Attention runs on the hand-written kernels through
:mod:`repro_torch.kernels.ops`: :func:`attention_chunked` (the reference's
two-level online-softmax form, its "XLA analog of the Pallas flash kernel")
calls ``flash_attention_op`` and :func:`attention_decode` calls
``decode_attention_op``. The kernels compute the function of the reference's
oracles, whose softmax weights stay in float32; the reference's
``attention_chunked`` and ``attention_decode`` round q·scale to the cache
type and the weights to v's type first. The two agree in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention import check_lengths
from repro_torch.kernels.ops import decode_attention_op, flash_attention_op

_DECODE_WINDOW_TODO = (
    "a sliding window in decode attention: no config reaches it (zamba2's "
    "decode keeps a ring buffer of window rows and passes none); the decode "
    "kernel takes no window (ROADMAP Queue 1 item 10)"
)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotary over last dim; positions: (..., S)."""
    D = x.shape[-1]
    half = D // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention on the flash-attention kernel.

    q: (B,Sq,H,D); k,v: (B,Skv,KH,D); GQA via H % KH == 0.
    q_offset: global position of q[0]. The kernel's causal mask and window
    put q[0] at Skv − Sq, so a causal or windowed call needs q_offset ==
    Skv − Sq (0 for a prefill over the whole sequence). ``window`` > 0 keeps
    key j for query i only if j > i + q_offset − window (the reference's
    ``_mask``). The reference's chunk sizes tile its XLA loops; the kernel
    tiles itself, so they have no counterpart.
    """
    Sq, Skv = q.shape[1], k.shape[1]
    if (causal or window > 0) and q_offset != Skv - Sq:
        raise NotImplementedError(
            f"causal or windowed attention with q_offset={q_offset} over Sq={Sq}, "
            f"Skv={Skv}: the kernel's mask is offset by Skv - Sq"
        )
    return flash_attention_op(q, k, v, causal=causal, scale=scale, window=window)


def attention_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """One-token attention over a cache on the decode-attention kernel.
    q:(B,H,D); caches:(B,S,KH,D); lengths:(B,) valid rows, at least 1.

    The kernel reads the caches in their storage type, sums in float32 and
    stops at each sequence's length."""
    if window > 0:
        raise NotImplementedError(_DECODE_WINDOW_TODO)
    return decode_attention_op(q, k_cache, v_cache, lengths, scale=scale)


def decode_rows(lengths: torch.Tensor, S: int) -> torch.Tensor:
    """``lengths + 1``: the rows each sequence attends once a decode step
    has written its new K/V row at ``lengths`` of an S-row cache, checked
    to lie in [1, S] *before* the write. A full cache (a length of S)
    raises ValueError here; the reference's scatter drops the row silently
    (JAX's out-of-bounds ``.at[].set``), and an index past the cache would
    be an IndexError on the CPU and a device-side assert on the card. Under
    :func:`~repro_torch.kernels.attention.lengths_checked` (a captured
    step) the caller has checked its host copy and nothing is read."""
    valid = lengths + 1
    check_lengths(valid, S, f"a decode step over a cache of {S} rows: lengths + 1")
    return valid


# ---------------------------------------------------------------------------
# Attention block (projections + rope + attention)
# ---------------------------------------------------------------------------


def attn_proj_qkv(p: dict, x: torch.Tensor, cfg) -> tuple:
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq_col"]
    k = x @ p["wk_col"]
    v = x @ p["wv_col"]
    if cfg.qkv_bias:
        q = q + p["bq_col"]
        k = k + p["bk_col"]
        v = v + p["bv_col"]
    B, S = x.shape[0], x.shape[1]
    return (
        q.reshape(B, S, H, hd),
        k.reshape(B, S, KH, hd),
        v.reshape(B, S, KH, hd),
    )


def attn_proj_kv(p: dict, x: torch.Tensor, cfg) -> tuple:
    """The K and V of :func:`attn_proj_qkv` without its query: a cross
    attention's cache, whose query comes from the decoder."""
    KH, hd = cfg.n_kv_heads, cfg.hd
    k = x @ p["wk_col"]
    v = x @ p["wv_col"]
    if cfg.qkv_bias:
        k = k + p["bk_col"]
        v = v + p["bv_col"]
    B, S = x.shape[0], x.shape[1]
    return k.reshape(B, S, KH, hd), v.reshape(B, S, KH, hd)


def expand_heads_for_tp(q, k, v, cfg):
    """Repeat-KV (GQA -> MHA view) + zero-pad heads to cfg.tp_pad_heads.

    Exact math: MHA head h uses repeated kv[h] == original kv[h // G], the
    same q->kv assignment GQA computes; zero-padded q heads produce outputs
    that the caller slices away before the output projection. A no-op when
    ``tp_pad_heads`` is 0, as for every config the port serves today."""
    Hp = getattr(cfg, "tp_pad_heads", 0)
    H, KH = q.shape[2], k.shape[2]
    if not Hp or Hp < H:
        return q, k, v, H
    if KH < H:
        G = H // KH
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    pad = Hp - H
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    return q, k, v, H


def attn_block(
    p: dict, x: torch.Tensor, cfg, *, positions, causal=True, window=0,
) -> torch.Tensor:
    """Full-sequence attention block (train/prefill). The reference's
    ``kv_override`` has no caller on the serving path (whisper's prefill
    projects its cross K/V itself) and is not ported."""
    B, S, _ = x.shape
    q, k, v = attn_proj_qkv(p, x, cfg)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q, k, v, H = expand_heads_for_tp(q, k, v, cfg)
    out = attention_chunked(q, k, v, causal=causal, window=window)
    out = out[:, :, :H].reshape(B, S, cfg.n_heads * cfg.hd)
    return out @ p["wo_row"]


def mlp_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.mlp_act == "silu_gated":
        g = x @ p["wg_col"]
        u = x @ p["wu_col"]
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    else:  # gelu (the reference's jax.nn.gelu is the tanh form)
        h = x @ p["wu_col"]
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return h @ p["wd_row"]


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens]


def lm_logits(x: torch.Tensor, out_embed: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D); out_embed: (D,V) column-parallel."""
    return x @ out_embed
