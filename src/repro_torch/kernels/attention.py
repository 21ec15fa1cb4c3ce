"""CUDA kernel wrappers for attention: the prefill's flash attention and the
decode step's cache attention.

They replace the Pallas ``flash_attention`` and ``decode_attention`` kernels
of the reference package; the kernels themselves are
``csrc/flash_attention.cu`` and ``csrc/decode_attention.cu``. Both take
float32 or bfloat16, sum in float32 and return q's type.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

D_MAX = 128  # the largest head dim the kernels take (a multiple of 8)
G_MAX = 16  # query heads per KV head the decode kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_operands(name: str, operands) -> None:
    """``operands``: (tensor, its name, its rank), q first; all must share
    q's device and dtype, be contiguous and 16-byte aligned (the kernels
    load eight elements at once)."""
    q = operands[0][0]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype}, expected float32 or bfloat16")
    for t, what, ndim in operands:
        _build.require(t, what, q.dtype, ndim, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    D = q.shape[-1]
    if D % 8 or not 8 <= D <= D_MAX:
        raise ValueError(f"{name}: head dim {D} must be a multiple of 8 in [8, {D_MAX}]")


def flash_attention(q, k, v, *, causal: bool, scale: float) -> torch.Tensor:
    """q:(B,Sq,H,D); k,v:(B,Skv,KH,D), H % KH == 0; one CUDA device,
    contiguous, one dtype. Returns (B,Sq,H,D) in q's dtype. The causal mask
    keeps key j for query i where i + (Skv - Sq) >= j, so Sq <= Skv."""
    _check_operands("flash_attention", ((q, "q", 4), (k, "k", 4), (v, "v", 4)))
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    if KH < 1 or H % KH:
        raise ValueError(f"flash_attention: {H} query heads over {KH} KV heads")
    if Skv < 1 or (causal and Sq > Skv):
        raise ValueError(f"flash_attention: Sq={Sq}, Skv={Skv}: every query needs a key")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dev = q.device
    with torch.cuda.device(dev):
        err = _build.lib().raven_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            B, Sq, Skv, H, KH, D, float(scale), int(bool(causal)), _build.stream_ptr(dev),
        )
    _build.check("flash_attention", err)
    _build.LAUNCHES["flash_attention"] += 1
    return out


def _check_lengths(lengths: torch.Tensor, S: int) -> None:
    """Every length in [1, S]. Reading them back to the host synchronises
    with the card, so a tensor that passed is marked with its version
    counter and not read again until it changes: a decode step hands the
    same lengths to every layer, and checks them once."""
    if getattr(lengths, "_raven_checked", None) == (lengths._version, S):
        return
    lo, hi = (int(x) for x in torch.aminmax(lengths))
    if lo < 1 or hi > S:
        raise ValueError(f"decode_attention: lengths span [{lo}, {hi}], must lie in [1, {S}]")
    lengths._raven_checked = (lengths._version, S)


def decode_attention(q, k_cache, v_cache, lengths, *, scale: float) -> torch.Tensor:
    """q:(B,H,D); k_cache,v_cache:(B,S,KH,D), H % KH == 0, H / KH <= 16;
    lengths:(B,) int32 valid rows, each in [1, S]. One CUDA device,
    contiguous. Returns (B,H,D) in q's dtype.

    A length of 0 would give the plain version's NaN (a softmax over no
    key), so it raises instead (see :func:`_check_lengths`)."""
    _check_operands("decode_attention", (
        (q, "q", 3), (k_cache, "k_cache", 4), (v_cache, "v_cache", 4)))
    _build.require(lengths, "lengths", torch.int32, 1, q.device)
    B, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D or lengths.shape[0] != B):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, lengths {tuple(lengths.shape)} disagree")
    if KH < 1 or H % KH or H // KH > G_MAX:
        raise ValueError(f"decode_attention: {H} query heads over {KH} KV heads "
                         f"(at most {G_MAX} a KV head)")
    out = torch.empty_like(q)
    if B == 0:
        return out
    _check_lengths(lengths, S)
    dev = q.device
    with torch.cuda.device(dev):
        err = _build.lib().raven_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype], B, S, H, KH, D, float(scale),
            _build.stream_ptr(dev),
        )
    _build.check("decode_attention", err)
    _build.LAUNCHES["decode_attention"] += 1
    return out
