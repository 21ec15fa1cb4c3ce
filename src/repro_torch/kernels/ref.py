"""Plain PyTorch versions of the four main-path kernels.

Line for line the reference package's jnp oracles: the CPU path runs them,
and the CUDA kernels are held against them on the card. Inputs are torch
tensors on any device; outputs land on the inputs' device.
"""
from __future__ import annotations

import torch


def tree_gemm_ref(x, A, B, C, D, V, base: float) -> torch.Tensor:
    """GEMM-strategy tree inference. x:(N,F); A:(T,F,I); B:(T,I); C:(T,I,L);
    D:(T,L); V:(T,L) -> (N,) raw scores."""
    S = torch.einsum("nf,tfi->nti", x.to(torch.float32), A)
    dec = (S <= B[None]).to(torch.float32)
    P = torch.einsum("nti,til->ntl", dec, C)
    match = (P == D[None]).to(torch.float32)
    return torch.einsum("ntl,tl->n", match, V) + base


def featurize_ref(num, cat, offset, scale, cat_values, cat_segments):
    """Fused scaler + one-hot + concat.

    num:(N,Kn) f32; cat:(N,Kc) int32; offset/scale:(Kn,);
    cat_values:(Vtot,) concatenated category values;
    cat_segments: list of (start, length) per categorical column.
    Output: (N, Kn + Vtot) f32, numerics first.
    """
    parts = [(num.to(torch.float32) - offset) * scale]
    for j, (s, l) in enumerate(cat_segments):
        vals = cat_values[s : s + l]
        parts.append((cat[:, j : j + 1] == vals[None, :]).to(torch.float32))
    return torch.cat(parts, dim=1)


def gather_join_ref(fk, skeys, spay):
    """Dim-table equi-join gather (unique, pre-sorted dim keys).

    fk:(N,) int32 fact keys; skeys:(M,) int32 sorted unique dim keys;
    spay:(M,P) f32 payload aligned to ``skeys``. Returns ``(out, hit)`` —
    out:(N,P) f32 (zero on miss), hit:(N,) bool.
    """
    if skeys.shape[0] == 0:
        hit = torch.zeros(fk.shape, dtype=torch.bool, device=fk.device)
        return spay.new_zeros((fk.shape[0], spay.shape[1])), hit
    pos = torch.clamp(torch.searchsorted(skeys, fk), 0, skeys.shape[0] - 1)
    hit = skeys[pos] == fk
    out = torch.where(hit[:, None], spay[pos], spay.new_zeros(()))
    return out, hit


def segment_agg_ref(vals, w, sid, *, num_segments):
    """Masked segmented aggregate.

    vals:(N,C) f32; w:(N,) f32 validity weights (the fused filter mask);
    sid:(N,) int32 segment ids in ``[0, num_segments)``. Returns
    ``(counts, sums, mins, maxs)``: counts:(S,), sums:(S,C) weighted sums,
    mins/maxs:(S,C) masked extrema (+inf/-inf for segments with no valid
    rows).
    """
    S = num_segments
    wf = w.to(torch.float32)
    vf = vals.to(torch.float32)
    C = vf.shape[1]
    inf = torch.tensor(float("inf"), device=vf.device)
    if S == 1:
        # global fold: plain reductions, not a scatter of N rows into one slot
        if vf.shape[0] == 0:
            return (
                vf.new_zeros((1,)),
                vf.new_zeros((1, C)),
                vf.new_full((1, C), float("inf")),
                vf.new_full((1, C), -float("inf")),
            )
        valid1 = (wf > 0)[:, None]
        counts = torch.sum(wf)[None]
        sums = torch.sum(vf * wf[:, None], dim=0)[None]
        mins = torch.amin(torch.where(valid1, vf, inf), dim=0)[None]
        maxs = torch.amax(torch.where(valid1, vf, -inf), dim=0)[None]
        return counts, sums, mins, maxs
    idx = sid.to(torch.int64)
    counts = vf.new_zeros((S,)).index_add_(0, idx, wf)
    sums = vf.new_zeros((S, C)).index_add_(0, idx, vf * wf[:, None])
    valid = (wf > 0)[:, None]
    idx2 = idx[:, None].expand(-1, C)
    mins = vf.new_full((S, C), float("inf")).scatter_reduce_(
        0, idx2, torch.where(valid, vf, inf), reduce="amin"
    )
    maxs = vf.new_full((S, C), -float("inf")).scatter_reduce_(
        0, idx2, torch.where(valid, vf, -inf), reduce="amax"
    )
    return counts, sums, mins, maxs
