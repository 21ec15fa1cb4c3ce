"""A plain-torch model of the ``segment_agg`` CUDA kernel's order of
operations (``src/repro_torch/kernels/csrc/segment_agg.cu``).

Shared by the CPU tests, which hold it against the reference package, and
the card's tests, which hold the kernel against it bit for bit on data where
the order of float32 additions shows. Counts and sums are added in the
kernel's order:

* block ``b`` of ``blocks`` takes rows ``[b * chunk, (b + 1) * chunk)``;
* register path: thread ``t`` meets the rows ``lo + t + 256 k`` in order
  and sums each run of rows with one segment id from 0, adding the run to
  its segment's sum when the id changes and at the end (a row of weight 0
  with finite values adds exactly 0, so it is passed over and ends no
  run); then a butterfly
  over the 32 lanes of each warp (lane ``i`` adds lane ``i ^ off`` for
  off = 16, 8, 4, 2, 1; every lane ends with the same bits), lane 0's
  value taken;
* shared path: warp ``w`` adds its rows (``lo + 256 k + 32 w + lane``) in
  row order;
* then the eight warps in warp order, then the blocks in block order.

Mins and maxs are exact in any order, so they are taken in one pass over the
rows with ``w > 0`` (NaN propagating).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.relational import AGG_THREADS, AGG_WARPS, agg_plan

SMS = 132  # an H100 SXM's multiprocessors


def segment_agg_model(vals, w, sid, *, num_segments: int, blocks: int | None = None,
                      registers: bool | None = None, sms: int = SMS):
    """vals:(N,C) f32, w:(N,) f32, sid:(N,) int32 (CPU tensors) →
    ``(counts, sums, mins, maxs)`` as the kernel computes them. ``blocks``
    and ``registers`` default to :func:`agg_plan`'s for a card of ``sms``
    multiprocessors; the shared path may be asked for at any S and C."""
    N, C = vals.shape
    S = num_segments
    plan = agg_plan(N, C, S, sms)
    G = plan.blocks if blocks is None else blocks
    regs = plan.registers if registers is None else registers
    chunk = -(-N // G) if N else 0
    # the added quantities of a row: its weight, then v * w per column
    x = torch.cat([w[:, None], vals * w[:, None]], dim=1)  # (N, 1 + C)
    passed_over = (w == 0) & torch.isfinite(vals).all(dim=1)  # adds exactly 0

    def rows_at(r):  # row indices (-1: none) -> (contributions, segment or -1)
        inb = (r < N) & (r >= 0)
        inb = inb & ~passed_over[r.clamp(0, max(N - 1, 0))] if N else inb
        rc = r.clamp(0, max(N - 1, 0))
        xs = x[rc] if N else x.new_zeros(r.shape + (1 + C,))
        seg = sid[rc].to(torch.int64) if N else torch.zeros(r.shape, dtype=torch.int64)
        return torch.where(inb[..., None], xs, 0.0), torch.where(inb, seg, -1)

    def spread(v, seg):  # (..., 1 + C) onto segment seg of (..., S, 1 + C), 0 elsewhere
        member = seg[..., None] == torch.arange(S)
        return torch.where(member[..., None], v[..., None, :], 0.0)

    b = torch.arange(G)[:, None]
    lo = b * chunk
    hi = torch.clamp(lo + chunk, max=N)
    steps = -(-chunk // AGG_THREADS)
    if regs:  # per thread in runs of one segment, then a butterfly in each warp
        t = torch.arange(AGG_THREADS)[None, :]
        acc = x.new_zeros((G, AGG_THREADS, S, 1 + C))
        run = x.new_zeros((G, AGG_THREADS, 1 + C))
        cur = torch.full((G, AGG_THREADS), -1, dtype=torch.int64)
        for k in range(steps):
            r = lo + t + AGG_THREADS * k
            xs, seg = rows_at(torch.where(r < hi, r, -1))
            new_run = (seg >= 0) & (seg != cur)
            acc = acc + spread(run, torch.where(new_run, cur, -1))
            run = torch.where(new_run[..., None], 0.0, run) + xs
            cur = torch.where(new_run, seg, cur)
        acc = acc + spread(run, cur)
        lanes = acc.reshape(G, AGG_WARPS, 32, S, 1 + C)
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, :, torch.arange(32) ^ off]
        warps = lanes[:, :, 0]
    else:  # per warp in row order
        wv = torch.arange(AGG_WARPS)[None, :]
        warps = x.new_zeros((G, AGG_WARPS, S, 1 + C))
        for k in range(steps):
            for lane in range(32):
                r = lo + AGG_THREADS * k + 32 * wv + lane
                warps = warps + spread(*rows_at(torch.where(r < hi, r, -1)))
    block = warps[:, 0]
    for k in range(1, AGG_WARPS):
        block = block + warps[:, k]
    total = block[0]
    for k in range(1, G):
        total = total + block[k]
    valid = (w > 0)[:, None]
    inf = torch.tensor(float("inf"))
    idx = sid.to(torch.int64)[:, None].expand(-1, C)
    mins = torch.full((S, C), float("inf")).scatter_reduce_(
        0, idx, torch.where(valid, vals, inf), reduce="amin")
    maxs = torch.full((S, C), -float("inf")).scatter_reduce_(
        0, idx, torch.where(valid, vals, -inf), reduce="amax")
    return total[:, 0].clone(), total[:, 1:].clone(), mins, maxs
