"""Dispatch for the hand-written kernels.

Policy: a CUDA tensor goes to the hand-written kernel (``featurize``,
``tree_gemm``, ``relational``, ``attention``), a CPU tensor to the plain
version in :mod:`repro_torch.kernels.ref`. There is no fallback between the two: a
CUDA input whose kernel cannot build or launch raises, and an input on any
other device raises. Callers pass natural shapes; the one padding the port
keeps (the GEMM program's) is provably inert, see :func:`pad_gemm_program`.

The two attention kernels are also PyTorch operators
(``torch.ops.repro_torch.flash_attention`` and ``...decode_attention``),
so that the dry run (:mod:`repro_torch.launch.dryrun`) can trace the card's
path on fake tensors and DTensors. Each has its kernel for CUDA tensors and
its plain version for CPU tensors, a fake implementation that gives the
output's shape and dtype and is reached only under ``FakeTensorMode``, a
FLOP formula for ``torch.utils.flop_counter`` and a DTensor sharding rule
over batch and heads. A call goes through the operator where something
must see it: a DTensor, a fake tensor, or any dispatch mode (the flop
counter, the dry run's cost mode). Plain CUDA tensors with no mode active
call the kernel's wrapper straight, which is what the operator's CUDA
implementation calls, without the operator's dispatch (26–75 µs a call on
the card's host). Either way a real CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.device import refuse_in_capture
from repro_torch.kernels import ref as _ref


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _route(t: torch.Tensor, op: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel or plain version for device {t.device}")


def kernels_enabled() -> bool:
    """``RAVEN_KERNELS`` knob: ``off``/``0`` routes relational stages through
    the legacy torch composition (searchsorted / index_add_ / scatter_reduce
    inline in the stage) instead of :func:`gather_join_op` /
    :func:`segment_agg_op`. Anything else (the default) uses the ops, which
    dispatch to the CUDA kernels for CUDA tensors and the plain versions on
    the CPU."""
    return os.environ.get("RAVEN_KERNELS", "on").lower() not in ("off", "0")


def kernel_mode_token(kernels: Optional[bool] = None) -> str:
    """Content token for the relational-kernel codegen mode (``kernels``,
    else the ``RAVEN_KERNELS`` knob's), folded into the fingerprints of
    stages (and plans) containing Join/Aggregate ops so the two modes never
    alias. The ``rt1`` prefix is this package's own, so its tokens never
    equal the reference package's."""
    on = kernels_enabled() if kernels is None else kernels
    return "rt1-on" if on else "rt1-off"


# ---------------------------------------------------------------------------
# tree_gemm
# ---------------------------------------------------------------------------


def pad_gemm_program(A, B, C, D, V, align: int = 8):
    """Pad F/I/L of a GEMM tree program up to multiples of ``align``.
    Inert padding proof:
      * extra F rows of A are zero → S unchanged (x is zero-padded to match,
        in the kernel or here);
      * extra I columns: threshold +inf ⇒ decision 1, but their C rows are
        zero ⇒ P unchanged;
      * extra L columns: Dcount = -1 can never equal a non-negative path
        count ⇒ match 0 ⇒ V never read (and V is 0 there anyway)."""
    T, F, I = A.shape
    L = C.shape[2]
    Fp, Ip, Lp = _round_up(F, align), _round_up(I, align), _round_up(L, align)
    A2 = np.zeros((T, Fp, Ip), np.float32)
    A2[:, :F, :I] = A
    B2 = np.full((T, Ip), np.float32(np.inf))
    B2[:, :I] = B
    C2 = np.zeros((T, Ip, Lp), np.float32)
    C2[:, :I, :L] = C
    D2 = np.full((T, Lp), np.float32(-1.0))
    D2[:, :L] = D
    V2 = np.zeros((T, Lp), np.float32)
    V2[:, :L] = V
    return A2, B2, C2, D2, V2


def tree_gemm_op(x, A, B, C, D, V, *, base: float, packed=None) -> torch.Tensor:
    """(N,F) rows → (N,) raw scores; A's F may exceed x's (padded program).
    ``packed`` is the program's ``pack_gemm_program`` on x's device, which
    the CUDA kernel reads (packed on the host per call when None); the plain
    version reads A…V."""
    x = x.to(torch.float32)
    if _route(x, "tree_gemm"):
        from repro_torch.kernels.tree_gemm import packed_on, tree_gemm

        if packed is None:
            refuse_in_capture("packing a tree_gemm program on the host")
            packed = packed_on(A, B, C, D, V, x.device)
        return tree_gemm(x.contiguous(), A, B, C, D, V, base, packed)
    Fk, F = A.shape[1], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, Fk - F)) if Fk > F else x
    return _ref.tree_gemm_ref(xp, A, B, C, D, V, base)


# ---------------------------------------------------------------------------
# featurize
# ---------------------------------------------------------------------------


def _parts(x) -> list:
    return [x] if torch.is_tensor(x) else list(x)


def stack_columns(x, n_rows: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """The columns of ``x`` (an (N,K) tensor, or a sequence of (N,) /
    (N,k) tensors) as one (N,K) tensor of ``dtype``: the plain version's
    input. A 2-D tensor is passed as it is."""
    if torch.is_tensor(x):
        return x
    parts = [(p[:, None] if p.dim() == 1 else p).to(dtype) for p in x]
    if not parts:
        return torch.zeros((n_rows, 0), dtype=dtype, device=device)
    return torch.cat(parts, 1)


def featurize_op(num, cat, offset, scale, cat_values, cat_segments, val_col=None):
    """Fused scaler + one-hot + concat → (N, Kn + Vtot) f32. ``num`` and
    ``cat`` are each an (N,K) tensor or a sequence of (N,) / (N,k) tensors
    (the kernel reads them in place; only the plain version stacks them).
    A column whose dtype is not float32 (numeric) or int32 (categorical) is
    converted on its own first. ``val_col`` is the kernel's expansion of
    ``cat_segments`` (built from them when not given; programs pass the
    copy they hold on the device)."""
    nums, cats = _parts(num), _parts(cat)
    if not nums and not cats:
        raise ValueError("featurize: no input tensor to take the row count from")
    probe = (nums + cats)[0]
    if _route(probe, "featurize"):
        from repro_torch.kernels.featurize import featurize, segment_columns

        if val_col is None:
            refuse_in_capture("copying featurize's val_col to the card")
            val_col = segment_columns(cat_segments, probe.device)
        return featurize(
            [p if p.dtype == torch.float32 else p.to(torch.float32) for p in nums],
            [p if p.dtype == torch.int32 else p.to(torch.int32) for p in cats],
            offset, scale, cat_values, val_col, cat_segments,
        )
    return _ref.featurize_ref(
        stack_columns(num, probe.shape[0], torch.float32, probe.device),
        stack_columns(cat, probe.shape[0], torch.int32, probe.device),
        offset, scale, cat_values, cat_segments,
    )


# ---------------------------------------------------------------------------
# relational: gather-join and masked segmented aggregate
# ---------------------------------------------------------------------------


def gather_join_op(fk, skeys, spay, *, records=None, lo: int = 0):
    """Dim-table equi-join gather. fk:(N,) int32; skeys:(M,) sorted *unique*
    int32 dim keys; spay:(M,P) f32 payload aligned to skeys. ``records``
    and ``lo``, where the Join step built them from the dimsort entry's
    direct-address index, are the kernel's dense route (the plain version
    searches). Returns ``(out, hit)``: out:(N,P) f32 (zero on miss),
    hit:(N,) bool."""
    if _route(fk, "gather_join"):
        from repro_torch.kernels.relational import gather_join

        return gather_join(fk.contiguous(), skeys.contiguous(), spay.contiguous(),
                           records=records, lo=lo)
    return _ref.gather_join_ref(fk, skeys, spay)


def segment_agg_op(vals, w, sid, *, num_segments: int):
    """Masked segmented aggregate. vals: the C value columns, an (N,C) f32
    tensor or a sequence of (N,) f32 tensors (the kernel reads them in
    place; only the plain version stacks them); w:(N,) f32 validity weights
    (the fused filter mask); sid:(N,) int32 in [0, num_segments), or None
    for a single segment. Returns ``(counts, sums, mins, maxs)`` — counts:(S,),
    the rest (S,C); mins/maxs are +inf/-inf where a segment has no valid
    rows (callers replace empties via ``counts > 0``)."""
    if _route(w, "segment_agg"):
        from repro_torch.kernels.relational import segment_agg

        return segment_agg(vals, w.contiguous(),
                           None if sid is None else sid.contiguous(),
                           num_segments=num_segments)
    if not torch.is_tensor(vals):
        vals = (torch.stack(list(vals), dim=1) if len(vals)
                else w.new_zeros((w.shape[0], 0), dtype=torch.float32))
    if sid is None:
        sid = torch.zeros(w.shape, dtype=torch.int32, device=w.device)
    return _ref.segment_agg_ref(vals, w, sid, num_segments=num_segments)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _refuse_grad(op: str, *ts) -> None:
    """The attention kernels have no backward: their output, written through
    ctypes, has no ``grad_fn``, so a gradient through them would be dropped
    without a word on the card (the plain versions on the CPU would give
    one). As the reference's ``pallas_call``, which cannot be
    differentiated, they refuse on every device an input that requires grad
    while grad mode is on; training attends through
    ``repro_torch.models.layers.attention_train``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{op}: an input requires grad, and the kernel has no backward; "
            "train through models.layers.attention_train (attn_block(train=True))"
        )


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs flash attention computes: all of them, or
    under the causal mask and window (query i at position i + Skv - Sq)
    those it keeps."""
    if not causal and window <= 0:
        return Sq * Skv
    off = Skv - Sq
    total = 0
    for i in range(Sq):
        hi = min(Skv - 1, i + off) if causal else Skv - 1
        lo = max(0, i + off - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def _flash_attention_cuda(q, k, v, causal: bool, scale: float, window: int) -> torch.Tensor:
    from repro_torch.kernels.attention import flash_attention

    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, scale=scale, window=window)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                     scale: float, window: int) -> torch.Tensor:
    return _flash_attention_cuda(q, k, v, causal, scale, window)


@_flash_attention.register_kernel("cpu")
def _(q, k, v, causal, scale, window):
    return _ref.flash_attention_ref(q, k, v, causal=causal, scale=scale, window=window)


@_flash_attention.register_fake
def _(q, k, v, causal, scale, window):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _decode_attention_cuda(q, k_cache, v_cache, lengths, scale: float) -> torch.Tensor:
    from repro_torch.kernels.attention import decode_attention

    return decode_attention(q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
                            lengths.to(torch.int32).contiguous(), scale=scale)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(), device_types="cuda")
def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      lengths: torch.Tensor, scale: float) -> torch.Tensor:
    return _decode_attention_cuda(q, k_cache, v_cache, lengths, scale)


@_decode_attention.register_kernel("cpu")
def _(q, k_cache, v_cache, lengths, scale):
    return _ref.decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)


@_decode_attention.register_fake
def _(q, k_cache, v_cache, lengths, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _register_counting_and_sharding() -> None:
    """The FLOP formulas and the DTensor sharding rules of the two ops.
    Flash attention: 4·D FLOPs a (query head, kept key) pair
    (:func:`attention_pairs`: q·k and p·v); decode attention: 4·D a query
    head and cache row, every row of the cache (the lengths are data, and a
    formula sees shapes only). Sharding: all replicated; the batch (dim 0)
    sharded alike on every input; or the heads (dim 2 of flash's q, k, v;
    dim 1 of decode's q, 2 of its caches) sharded alike, which keeps each
    query head with its KV head only where the KV heads divide the whole
    mesh (whole groups a rank, however the mesh dims combine)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _(q_shape, k_shape, v_shape, causal, scale, window, *args, **kwargs) -> int:
        B, Sq, H, D = q_shape
        return 4 * B * H * D * attention_pairs(Sq, k_shape[1], causal, window)

    @register_flop_formula(torch.ops.repro_torch.decode_attention)
    def _(q_shape, k_shape, v_shape, lengths_shape, scale, *args, **kwargs) -> int:
        B, H, D = q_shape
        return 4 * B * H * D * k_shape[1]

    def heads_divide(kv) -> bool:
        return kv.shape[2] % kv.mesh.size() == 0

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _(q, k, v, causal, scale, window):
        tail = [None, None, None]
        out = [([Replicate()], [Replicate()] * 3 + tail), ([Shard(0)], [Shard(0)] * 3 + tail)]
        if heads_divide(k):
            out.append(([Shard(2)], [Shard(2)] * 3 + tail))
        return out

    @register_sharding(torch.ops.repro_torch.decode_attention.default)
    def _(q, k_cache, v_cache, lengths, scale):
        out = [([Replicate()], [Replicate()] * 4 + [None]),
               ([Shard(0)], [Shard(0)] * 4 + [None])]
        if heads_divide(k_cache):
            out.append(([Shard(1)], [Shard(1), Shard(2), Shard(2), Replicate(), None]))
        return out


_register_counting_and_sharding()


def _through_op(*ts: torch.Tensor) -> bool:
    """Whether a call goes through the registered operator: a DTensor (its
    sharding rule), a fake tensor (its fake implementation, under the dry
    run's ``FakeTensorMode``), or any tensor under a dispatch mode (which
    must see the operator, as ``FlopCounterMode`` its formula). Plain
    tensors with no mode active go to the kernel's wrapper (CUDA) or the
    plain version (CPU) directly."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    return (_get_current_dispatch_mode() is not None
            or any(type(t) is not torch.Tensor or is_fake(t) for t in ts))


def flash_attention_op(q, k, v, *, causal: bool = True, scale: float | None = None,
                       window: int = 0):
    """q:(B,Sq,H,D); k,v:(B,Skv,KH,D), H % KH == 0 → (B,Sq,H,D) in q's
    dtype, float32 sums. The causal mask is offset by Skv − Sq; ``window``
    > 0 keeps only the ``window`` latest keys of each query's position.
    Refuses inputs that require grad (:func:`_refuse_grad`)."""
    _refuse_grad("flash_attention", q, k, v)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} must be >= 0 (0: none)")
    if _through_op(q, k, v):
        return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), float(scale),
                                                     int(window))
    if _route(q, "flash_attention"):
        return _flash_attention_cuda(q, k, v, bool(causal), float(scale), int(window))
    return _ref.flash_attention_ref(q, k, v, causal=causal, scale=scale, window=window)


def decode_attention_op(q, k_cache, v_cache, lengths, *, scale: float | None = None):
    """q:(B,H,D); k_cache,v_cache:(B,S,KH,D); lengths:(B,) valid rows of
    each cache, at least 1 → (B,H,D) in q's dtype, float32 sums. Refuses
    inputs that require grad (:func:`_refuse_grad`)."""
    _refuse_grad("decode_attention", q, k_cache, v_cache)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if _through_op(q, k_cache, v_cache, lengths):
        return torch.ops.repro_torch.decode_attention(q, k_cache, v_cache, lengths,
                                                      float(scale))
    if _route(q, "decode_attention"):
        return _decode_attention_cuda(q, k_cache, v_cache, lengths, float(scale))
    return _ref.decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)
