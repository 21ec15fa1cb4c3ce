"""CUDA kernel wrappers for the relational half of the runtime: dim-table
gather-join and masked segmented aggregation.

They replace the Pallas ``gather_join`` and ``segment_agg`` kernels of the
reference package; the kernels themselves are ``csrc/gather_join.cu`` and
``csrc/segment_agg.cu``. They let Join and Filter→Aggregate chains run
inside a pure stage: the upstream filter's validity mask is fused
downstream (``valid & hit``) and folded into the aggregate as its weight, so
filtered rows are never materialized.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import _build

JOIN_SEARCH_THREADS = 1024  # the search route's blocks (the kernel's SEARCH_THREADS)

AGG_THREADS = 256  # the kernel's THREADS: eight warps
AGG_WARPS = AGG_THREADS // 32
AGG_MIN_ROWS = 2048  # rows a block takes at least
AGG_SMEM = 200 * 1024  # shared memory a block may take: slices, staged rows, the fold
AGG_REG_SEGMENTS, AGG_REG_COLS = 8, 3  # the register path's largest S and C
AGG_MAX_COLS = 64  # value columns one launch takes (the kernel's MAXC)
AGG_SLOTS = 1024  # completion counters (the kernel's SLOTS)

# The kernel's completion counters are per process and device, so the map
# from (device, stream) to counter is too.
_slots: dict[tuple[int, int], int] = {}
_slots_lock = threading.Lock()


def dense_records(index, spay) -> torch.Tensor:
    """The dense route's table, built once per dim table and payload
    columns: for each slot of ``index`` (R,) int32, a record of W int32
    words, W = P + 1 rounded up to a multiple of four: the slot's position in
    the sorted keys (-1 where no key has it), then the bits of the key's P
    payload floats (zero where none). One 16-byte load of a slot finds the
    key and, for P <= 3, all its payload."""
    P = spay.shape[1]
    records = torch.zeros((index.shape[0], -(-(P + 1) // 4) * 4), dtype=torch.int32,
                          device=index.device)
    records[:, 0] = index
    hit = index >= 0
    records[hit, 1:1 + P] = spay.contiguous().view(torch.int32)[index[hit].long()]
    return records


def gather_join(fk, skeys, spay, *, records=None, lo: int = 0):
    """fk:(N,) int32 fact keys; skeys:(M,) int32 sorted *unique* dim keys;
    spay:(M,P) f32 payload aligned to ``skeys``; one CUDA device,
    contiguous. ``records``, where given, is the dense route's table
    (:func:`dense_records`: the slot of key ``k`` is row ``k - lo``): the
    kernel then reads one record a row instead of searching. Returns
    ``(out, hit)``: out:(N,P) f32 (zero on miss), hit:(N,) bool."""
    dev = fk.device
    if dev.type != "cuda":
        raise ValueError(f"gather_join kernel needs CUDA tensors, got {dev}")
    _build.require(fk, "fk", torch.int32, 1, dev)
    _build.require(skeys, "skeys", torch.int32, 1, dev)
    _build.require(spay, "spay", torch.float32, 2, dev)
    N, (M, P) = fk.shape[0], spay.shape
    if skeys.shape[0] != M:
        raise ValueError("gather_join: skeys and spay disagree on M")
    span, width = 0, 0
    if records is not None:
        _build.require(records, "records", torch.int32, 2, dev)
        span, width = records.shape
        if width % 4 or width < P + 1:
            raise ValueError(f"gather_join: records of {width} words for P={P}")
    out = torch.empty((N, P), dtype=torch.float32, device=dev)
    hit = torch.empty((N,), dtype=torch.bool, device=dev)
    if N == 0:
        return out, hit
    blocks = max(1, min(-(-N // JOIN_SEARCH_THREADS), _build.sm_count(dev)))
    with torch.cuda.device(dev):
        err = _build.lib().raven_gather_join(
            fk.data_ptr(), skeys.data_ptr(), spay.data_ptr(),
            None if records is None else records.data_ptr(), int(lo), span, width,
            out.data_ptr(), hit.data_ptr(), N, M, P, blocks, _build.stream_ptr(dev),
        )
    _build.check("gather_join", err)
    _build.launched("gather_join")
    return out, hit


class AggPlan(NamedTuple):
    """One ``segment_agg`` launch: the path (per-thread accumulators in
    registers, else per-warp slices in shared memory), ``blocks`` row ranges
    of ``chunk`` rows, segment ``groups`` of ``group_segments`` (the shared
    path's, where eight slices of all segments do not fit), whether the last
    block stages every partial in shared memory to fold it, and the dynamic
    shared memory in bytes."""

    registers: bool
    blocks: int
    chunk: int
    groups: int
    group_segments: int
    stage: bool
    smem: int


def agg_plan(n_rows: int, n_cols: int, n_segments: int, sms: int) -> AggPlan:
    """The launch for N rows, C value columns and S segments on a card of
    ``sms`` multiprocessors. Blocks take ``AGG_MIN_ROWS`` rows at least and
    are one an SM at most; the last block stages their (S, 3C + 1) partials
    in shared memory where they fit ``AGG_SMEM``, else folds them from L2."""
    C, S = n_cols, n_segments
    E = 3 * C + 1
    registers = S <= AGG_REG_SEGMENTS and C <= AGG_REG_COLS
    if registers:
        group, row_bytes = S, 4 * AGG_WARPS * S * E
    else:
        staged_rows = 4 * AGG_THREADS * (C + 2)
        group = min(S, max(1, (AGG_SMEM - staged_rows) // (4 * AGG_WARPS * E)))
        row_bytes = staged_rows + 4 * AGG_WARPS * group * E
    partial = 4 * S * E
    blocks = max(1, min(-(-n_rows // AGG_MIN_ROWS), sms))
    stage = blocks * partial <= AGG_SMEM
    return AggPlan(registers, blocks, -(-n_rows // blocks), -(-S // group), group,
                   stage, max(row_bytes, blocks * partial if stage else 0))


def _slot(dev: torch.device, stream: int) -> int:
    """The completion counter of launches on ``stream``: concurrent streams
    never share one, and launches on one stream run in order, each leaving
    its counter at 0."""
    key = (dev.index, stream)
    with _slots_lock:
        if key not in _slots:
            if len(_slots) >= AGG_SLOTS:
                raise RuntimeError(f"segment_agg: more than {AGG_SLOTS} streams")
            _slots[key] = len(_slots)
        return _slots[key]


def segment_agg(vals, w, sid: Optional[torch.Tensor], *, num_segments: int):
    """vals: the C value columns, an (N,C) f32 tensor or a sequence of (N,)
    f32 tensors of any stride, read in place; w:(N,) f32 validity weights
    (the fused filter mask); sid:(N,) int32 segment ids in
    ``[0, num_segments)``, or None when ``num_segments`` is 1; one CUDA
    device. Returns ``(counts, sums, mins, maxs)``: counts:(S,) sums of w,
    sums:(S,C) sums of vals·w, mins/maxs:(S,C) extrema over rows with
    w > 0 (+inf/-inf where a segment has none). One launch per
    ``AGG_MAX_COLS`` columns; sums in a fixed order, no float atomics."""
    dev = w.device
    if dev.type != "cuda":
        raise ValueError(f"segment_agg kernel needs CUDA tensors, got {dev}")
    if torch.is_tensor(vals) and vals.dim() != 2:
        raise ValueError(f"segment_agg: vals is {vals.dim()}-D, expected (N, C)")
    cols: Sequence = list(vals.unbind(1)) if torch.is_tensor(vals) else list(vals)
    _build.require(w, "w", torch.float32, 1, dev)
    N, S = w.shape[0], int(num_segments)
    if S < 1:
        raise ValueError("segment_agg: num_segments must be >= 1")
    if sid is None:
        if S != 1:
            raise ValueError("segment_agg: sid is needed when num_segments > 1")
    else:
        _build.require(sid, "sid", torch.int32, 1, dev)
        if sid.shape[0] != N:
            raise ValueError("segment_agg: w and sid disagree on N")
    for j, c in enumerate(cols):
        if not (torch.is_tensor(c) and c.device == dev and c.dtype == torch.float32
                and c.dim() == 1 and c.shape[0] == N):
            raise ValueError(f"segment_agg: column {j} is not an ({N},) float32 "
                             f"tensor on {dev}")
    if len(cols) > AGG_MAX_COLS:
        parts = [segment_agg(cols[k:k + AGG_MAX_COLS], w, sid, num_segments=S)
                 for k in range(0, len(cols), AGG_MAX_COLS)]
        return (parts[0][0], *(torch.cat([p[i] for p in parts], dim=1) for i in (1, 2, 3)))
    return _segment_agg_launch(cols, w, sid, S, dev)


def _segment_agg_launch(cols, w, sid, S: int, dev: torch.device):
    N, C = w.shape[0], len(cols)
    plan = agg_plan(N, C, S, _build.sm_count(dev))
    partials = torch.empty((plan.blocks * S * (3 * C + 1),), dtype=torch.float32, device=dev)
    counts = torch.empty((S,), dtype=torch.float32, device=dev)
    sums = torch.empty((S, C), dtype=torch.float32, device=dev)
    mins = torch.empty((S, C), dtype=torch.float32, device=dev)
    maxs = torch.empty((S, C), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * max(C, 1))(*(c.data_ptr() for c in cols))
    strides = (ctypes.c_longlong * max(C, 1))(*(c.stride(0) for c in cols))
    stream = _build.stream_ptr(dev)
    with torch.cuda.device(dev):
        err = _build.lib().raven_segment_agg(
            ctypes.addressof(ptrs), ctypes.addressof(strides), C, w.data_ptr(),
            None if sid is None or S == 1 else sid.data_ptr(), partials.data_ptr(),
            counts.data_ptr(), sums.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
            N, S, int(plan.registers), plan.blocks, plan.chunk, plan.groups,
            plan.group_segments, int(plan.stage), plan.smem, _slot(dev, stream), stream,
        )
    _build.check("segment_agg", err)
    _build.launched("segment_agg")
    return counts, sums, mins, maxs
