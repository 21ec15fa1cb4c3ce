"""CUDA kernel wrappers for attention: the prefill's flash attention and the
decode step's cache attention.

They replace the Pallas ``flash_attention`` and ``decode_attention`` kernels
of the reference package. Both take float32 or bfloat16, sum in float32 and
return q's type. Flash attention has two kernels, chosen by dtype:
bfloat16 runs on the tensor cores (``csrc/flash_attention_wgmma.cu``),
float32 on CUDA-core FMAs (``csrc/flash_attention.cu``), because the tensor
cores take float32 only as TF32, which would break float32's 2e-5 parity.
Decode attention is one split-KV kernel in two passes
(``csrc/decode_attention.cu``), split by :func:`decode_splits`.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.device import refuse_in_capture
from repro_torch.kernels import _build

D_MAX = 128  # the largest head dim the kernels take (a multiple of 8)
G_MAX = 16  # query heads per KV head the decode kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLASH = {torch.float32: "raven_flash_attention_f32",
          torch.bfloat16: "raven_flash_attention_bf16"}

SPLIT_TILE = 64  # keys of the bf16 decode kernel's tile: a chunk is whole tiles
SPLIT_MIN_ROWS = 128  # the shortest chunk worth a block of its own
SPLIT_BLOCKS = 4 * 132  # blocks a decode call aims at: four per H100 SM


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


def flash_attention(q, k, v, *, causal: bool, scale: float, window: int = 0) -> torch.Tensor:
    """q:(B,Sq,H,D); k,v:(B,Skv,KH,D), H % KH == 0; one CUDA device,
    contiguous, one dtype. Returns (B,Sq,H,D) in q's dtype. The causal mask
    keeps key j for query i where i + (Skv - Sq) >= j, so Sq <= Skv; a
    ``window`` > 0 keeps only keys j > i + (Skv - Sq) - window. A window of
    Skv or more masks nothing and runs as none (0)."""
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
    if window < 0:
        raise ValueError(f"flash_attention: window {window} must be >= 0 (0: none)")
    window = 0 if window >= Skv else int(window)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dev = q.device
    with torch.cuda.device(dev):
        err = getattr(_build.lib(), _FLASH[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, KH, D, float(scale), int(bool(causal)), window,
            _build.stream_ptr(dev),
        )
    _build.check("flash_attention", err)
    _build.launched("flash_attention")
    return out


def decode_splits(S: int, B: int, KH: int) -> tuple[int, int]:
    """How the decode kernel cuts a cache of S rows: ``(n_split, chunk)``,
    split i taking rows [i * chunk, (i + 1) * chunk). It depends on S and
    B * KH only, never on the lengths (reading them would synchronise the
    host with the card): enough splits that B * KH * n_split blocks come
    near ``SPLIT_BLOCKS``, no chunk shorter than ``SPLIT_MIN_ROWS`` unless S
    is, every chunk a whole number of ``SPLIT_TILE``-row tiles, and no split
    empty of rows. Splits past a sequence's length cost a block that writes
    an empty partial."""
    if S < 1 or B < 1 or KH < 1:
        raise ValueError(f"decode_splits: S={S}, B={B}, KH={KH} must be positive")
    want = max(1, SPLIT_BLOCKS // (B * KH))
    n = min(want, -(-S // SPLIT_MIN_ROWS))
    chunk = -(-S // n)
    chunk = -(-chunk // SPLIT_TILE) * SPLIT_TILE
    return -(-S // chunk), chunk


_caller = threading.local()  # .checked: the caller holds the lengths in [1, S]


@contextlib.contextmanager
def lengths_checked():
    """Inside, :func:`decode_attention` does not read the lengths back: the
    caller has checked its host copy of them. A captured decode tick runs
    so (a graph cannot read device memory to the host); it checks the host
    lengths before every replay."""
    prev = getattr(_caller, "checked", False)
    _caller.checked = True
    try:
        yield
    finally:
        _caller.checked = prev


def check_lengths(lengths: torch.Tensor, S: int, what: str = "decode_attention: lengths"
                  ) -> None:
    """Every length in [1, S], else ValueError naming ``what``. Reading
    them back to the host synchronises with the card, so a tensor that
    passed is marked with its version counter and not read again until it
    changes: a decode step hands the same lengths to every layer, and
    checks them once. A capture cannot read them: there the caller checks
    (:func:`lengths_checked`), and the check raises otherwise. A fake
    tensor (the dry run's) has no values and is not checked."""
    if getattr(_caller, "checked", False) or is_fake(lengths):
        return
    if getattr(lengths, "_raven_checked", None) == (lengths._version, S):
        return
    refuse_in_capture(f"the check of {what}")
    lo, hi = (int(x) for x in torch.aminmax(lengths))
    if lo < 1 or hi > S:
        raise ValueError(f"{what} span [{lo}, {hi}], must lie in [1, {S}]")
    lengths._raven_checked = (lengths._version, S)


def decode_attention(q, k_cache, v_cache, lengths, *, scale: float) -> torch.Tensor:
    """q:(B,H,D); k_cache,v_cache:(B,S,KH,D), H % KH == 0, H / KH <= 16;
    lengths:(B,) int32 valid rows, each in [1, S]. One CUDA device,
    contiguous. Returns (B,H,D) in q's dtype.

    A length of 0 would give the plain version's NaN (a softmax over no
    key), so it raises instead (see :func:`check_lengths`)."""
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
    check_lengths(lengths, S)
    n_split, chunk = decode_splits(S, B, KH)
    # pass 1's partials: acc (B, KH, n_split, G, D), then (m, l) a head
    scratch = torch.empty(B * KH * n_split * (H // KH) * (D + 2), dtype=torch.float32,
                          device=q.device)
    dev = q.device
    with torch.cuda.device(dev):
        err = _build.lib().raven_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), _DTYPES[q.dtype], B, S, H, KH, D,
            float(scale), n_split, chunk, _build.stream_ptr(dev),
        )
    _build.check("decode_attention", err)
    _build.launched("decode_attention")
    return out
