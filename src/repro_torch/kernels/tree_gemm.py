"""CUDA kernel wrapper: GEMM-strategy tree-ensemble scoring.

Replaces the Pallas ``tree_gemm`` kernel of the reference package; the
kernel itself is ``csrc/tree_gemm.cu``. Per row and tree it runs the fused
chain ``S = X·A → D = (S ≤ B) → P = D·C → match = (P == Dcount) →
y += match·V`` without writing any intermediate to device memory, with the
trees as a loop inside the block (the TPU's sequential grid axis).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

ROWS = 64  # rows per block: the kernel's ROWS
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper


def smem_bytes(FC: int, I: int, L: int, chunked: bool = False) -> int:
    """Dynamic shared memory of one block staging ``FC`` features at a time
    (mirrors the kernel's layout; a ``chunked`` program, F > FC, also keeps
    each row's partial S)."""
    return 4 * (FC * ROWS + L * ROWS + FC * I + I + I * L + 2 * L
                + (I * ROWS if chunked else 0))


def feature_chunk(F: int, I: int, L: int) -> int:
    """Features the kernel stages per pass: all ``F`` when they fit one
    block's shared memory, else the most that do, a multiple of 8 (x is then
    restaged per tree). Raises when not even 8 fit, which takes far more
    nodes per tree than the GEMM strategy is chosen for."""
    if smem_bytes(F, I, L) <= SMEM_LIMIT:
        return max(F, 1)
    fc = (SMEM_LIMIT - smem_bytes(0, I, L, chunked=True)) // (4 * (ROWS + I)) // 8 * 8
    if fc < 8:
        raise ValueError(
            f"tree_gemm: a program with I={I} internal and L={L} leaf columns "
            f"needs {smem_bytes(8, I, L, chunked=True)} bytes of shared memory "
            "per block"
        )
    return fc


def tree_gemm(x, A, B, C, D, V, base: float) -> torch.Tensor:
    """x:(N,Fx) f32 with Fx <= F; A:(T,F,I); B:(T,I); C:(T,I,L); D:(T,L);
    V:(T,L), all f32 on one CUDA device, contiguous. Columns of A past x's
    width meet zeros (the inert rows of a padded program). Returns (N,) raw
    ensemble scores."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"tree_gemm kernel needs CUDA tensors, got {dev}")
    _build.require(x, "x", torch.float32, 2, dev)
    for t, name, nd in ((A, "A", 3), (B, "B", 2), (C, "C", 3), (D, "D", 2), (V, "V", 2)):
        _build.require(t, name, torch.float32, nd, dev)
    N, Fx = x.shape
    T, F, I = A.shape
    L = C.shape[2]
    if Fx > F:
        raise ValueError(f"tree_gemm: x has {Fx} features, program has {F}")
    if B.shape != (T, I) or C.shape != (T, I, L) or D.shape != (T, L) or V.shape != (T, L):
        raise ValueError("tree_gemm: program shapes disagree")
    fc = feature_chunk(F, I, L)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    with torch.cuda.device(dev):
        err = _build.lib().raven_tree_gemm(
            x.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), V.data_ptr(), out.data_ptr(), float(base),
            N, Fx, T, F, I, L, fc, _build.stream_ptr(dev),
        )
    _build.check("tree_gemm", err)
    _build.LAUNCHES["tree_gemm"] += 1
    return out
