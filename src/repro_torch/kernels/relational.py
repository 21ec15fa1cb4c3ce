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

import torch

from repro_torch.kernels import _build

AGG_ROWS_PER_BLOCK = 1024  # rows of one pass-1 chunk, before the cap below
AGG_MAX_BLOCKS = 1024  # pass-1 chunks per column: bounds the scratch


def gather_join(fk, skeys, spay) -> tuple[torch.Tensor, torch.Tensor]:
    """fk:(N,) int32 fact keys; skeys:(M,) int32 sorted *unique* dim keys;
    spay:(M,P) f32 payload aligned to ``skeys``; one CUDA device,
    contiguous. Returns ``(out, hit)``: out:(N,P) f32 (zero on miss),
    hit:(N,) bool."""
    dev = fk.device
    if dev.type != "cuda":
        raise ValueError(f"gather_join kernel needs CUDA tensors, got {dev}")
    _build.require(fk, "fk", torch.int32, 1, dev)
    _build.require(skeys, "skeys", torch.int32, 1, dev)
    _build.require(spay, "spay", torch.float32, 2, dev)
    N, (M, P) = fk.shape[0], spay.shape
    if skeys.shape[0] != M:
        raise ValueError("gather_join: skeys and spay disagree on M")
    out = torch.empty((N, P), dtype=torch.float32, device=dev)
    hit = torch.empty((N,), dtype=torch.bool, device=dev)
    if N == 0:
        return out, hit
    with torch.cuda.device(dev):
        err = _build.lib().raven_gather_join(
            fk.data_ptr(), skeys.data_ptr(), spay.data_ptr(), out.data_ptr(),
            hit.data_ptr(), N, M, P, _build.stream_ptr(dev),
        )
    _build.check("gather_join", err)
    _build.LAUNCHES["gather_join"] += 1
    return out, hit


def agg_blocks(n_rows: int) -> int:
    """Pass-1 chunks per column for ``n_rows`` rows (at least one, so an
    empty input still yields the empty-segment results)."""
    return max(1, min(AGG_MAX_BLOCKS, -(-n_rows // AGG_ROWS_PER_BLOCK)))


def segment_agg(vals, w, sid, *, num_segments: int):
    """vals:(N,C) f32; w:(N,) f32 validity weights (the fused filter mask);
    sid:(N,) int32 segment ids in ``[0, num_segments)``; one CUDA device,
    contiguous. Returns ``(counts, sums, mins, maxs)``: counts:(S,) sums of
    w, sums:(S,C) sums of vals·w, mins/maxs:(S,C) extrema over rows with
    w > 0 (+inf/-inf where a segment has none). Deterministic: two passes,
    no atomics."""
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"segment_agg kernel needs CUDA tensors, got {dev}")
    _build.require(vals, "vals", torch.float32, 2, dev)
    _build.require(w, "w", torch.float32, 1, dev)
    _build.require(sid, "sid", torch.int32, 1, dev)
    N, C = vals.shape
    S = int(num_segments)
    if w.shape[0] != N or sid.shape[0] != N:
        raise ValueError("segment_agg: vals/w/sid disagree on N")
    if S < 1:
        raise ValueError("segment_agg: num_segments must be >= 1")
    G = agg_blocks(N)
    partials = torch.empty((3 * (C + 1) * S * G,), dtype=torch.float32, device=dev)
    counts = torch.empty((S,), dtype=torch.float32, device=dev)
    sums = torch.empty((S, C), dtype=torch.float32, device=dev)
    mins = torch.empty((S, C), dtype=torch.float32, device=dev)
    maxs = torch.empty((S, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().raven_segment_agg(
            vals.data_ptr(), w.data_ptr(), sid.data_ptr(), partials.data_ptr(),
            counts.data_ptr(), sums.data_ptr(), mins.data_ptr(), maxs.data_ptr(),
            N, C, S, G, _build.stream_ptr(dev),
        )
    _build.check("segment_agg", err)
    _build.LAUNCHES["segment_agg"] += 1
    return counts, sums, mins, maxs
