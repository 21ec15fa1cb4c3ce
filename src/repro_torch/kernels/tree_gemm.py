"""CUDA kernel wrapper: GEMM-strategy tree-ensemble scoring.

Replaces the Pallas ``tree_gemm`` kernel of the reference package; the
kernel itself is ``csrc/tree_gemm.cu``. It computes the same function as the
chain ``S = X·A → D = (S ≤ B) → P = D·C → match = (P == Dcount) →
y += match·V``, but not as matrix products: A is one-hot per internal node,
so S is a gather of one feature, and with C in {-1, 0, 1} a leaf matches
exactly when every left ancestor decided 1 and every right ancestor decided
0, a test of the row's decision bits against two bit masks.
:func:`pack_gemm_program` turns the padded program into that form once, at
compile time, and refuses programs for which the two are not the same.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

ROWS = 256  # rows per block: the kernel's ROWS
XS = ROWS + 1  # column stride of x in shared memory (the kernel's XS)
W_MAX = 6  # decision words held in registers (I <= 192); more take the wide path
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
X_SMEM_LIMIT = 96 * 1024  # most bytes of staged x: two blocks still fit an SM
CHUNK_SMEM = 16 * 1024  # bytes of packed trees staged per pass


class PackedGemmProgram(NamedTuple):
    """A GEMM tree program in the kernel's form (int32 arrays, numpy or
    torch). Per tree ``t``:

    * ``nodes[t, i]`` = (feature of internal node i, or -1 where A's column
      is zero; the bits of its threshold ``B[t, i]`` as float32);
    * ``leaves[t, k]`` for the k-th live leaf (``k < counts[t, 1]``, in
      column order): ``W`` words of (left mask, right mask), bit i set where
      ``C[t, i, l]`` is +1 (left) or -1 (right), then (the bits of
      ``V[t, l]`` as float32, its column l). Entries past the live leaves
      are zero, with column -1;
    * ``counts[t]`` = (nodes to evaluate: one past the last node a live leaf
      tests, live leaves).
    """

    nodes: np.ndarray  # (T, I, 2)
    leaves: np.ndarray  # (T, L, W + 1, 2)
    counts: np.ndarray  # (T, 2)


def decision_words(I: int) -> int:
    """32-bit words that hold one decision bit per internal node."""
    return max(1, -(-I // 32))


def pack_gemm_program(A, B, C, D, V) -> PackedGemmProgram:
    """Pack a (padded) GEMM program A:(T,F,I), B:(T,I), C:(T,I,L),
    D:(T,L), V:(T,L) for the kernel. Raises ``ValueError``, naming the tree
    and the node or leaf, where the packed test would not equal
    ``D·C == Dcount`` exactly: a column of A with more than one nonzero or a
    nonzero other than 1; an entry of C outside {-1, 0, 1}; a leaf whose
    Dcount is attainable (an integer in [-#(-1), #(+1)] of its column of C)
    and yet not its count of +1 entries; a value of V that is not finite
    (0·V must be 0). A leaf whose Dcount is unattainable, such as padding's
    -1 on a zero column, can never match and is left out."""
    A = np.asarray(A, np.float32)
    B = np.ascontiguousarray(B, np.float32)
    C = np.asarray(C, np.float32)
    D = np.asarray(D, np.float32)
    V = np.ascontiguousarray(V, np.float32)
    T, F, I = A.shape
    L = C.shape[2]
    if B.shape != (T, I) or C.shape != (T, I, L) or D.shape != (T, L) or V.shape != (T, L):
        raise ValueError("pack_gemm_program: program shapes disagree")
    nz = A != 0
    per_node = nz.sum(axis=1)  # (T, I)
    for t, i in np.argwhere(per_node > 1)[:1]:
        raise ValueError(f"tree {t} node {i}: column of A has {per_node[t, i]} nonzeros")
    for t, f, i in np.argwhere(nz & (A != 1))[:1]:
        raise ValueError(f"tree {t} node {i}: A[{t}, {f}, {i}] = {A[t, f, i]}, not 1")
    for t, i, l in np.argwhere((C != 0) & (C != 1) & (C != -1))[:1]:
        raise ValueError(f"tree {t} leaf {l}: C[{t}, {i}, {l}] = {C[t, i, l]}, "
                         "not -1, 0 or 1")
    left, right = C == 1, C == -1  # (T, I, L)
    n_left, n_right = left.sum(axis=1), right.sum(axis=1)  # (T, L)
    with np.errstate(invalid="ignore"):
        live = (np.isfinite(D) & (D == np.round(D)) & (D >= -n_right) & (D <= n_left))
    for t, l in np.argwhere(live & (D != n_left))[:1]:
        raise ValueError(f"tree {t} leaf {l}: Dcount {D[t, l]} is attainable but "
                         f"is not the leaf's {n_left[t, l]} left ancestors")
    for t, l in np.argwhere(~np.isfinite(V))[:1]:
        raise ValueError(f"tree {t} leaf {l}: value {V[t, l]} is not finite")

    W = decision_words(I)
    weight = (np.uint64(1) << np.arange(32, dtype=np.uint64))[None, None, :, None]

    def words(m):  # (T, I, L) bool -> (T, L, W) uint32 bit masks
        padded = np.zeros((T, 32 * W, L), bool)
        padded[:, :I] = m
        w = (padded.reshape(T, W, 32, L) * weight).sum(axis=2, dtype=np.uint64)
        return w.astype(np.uint32).transpose(0, 2, 1)

    order = np.argsort(~live, axis=1, kind="stable")  # live leaves first
    n_live = live.sum(axis=1)
    kept = np.arange(L)[None, :] < n_live[:, None]  # (T, L) over packed slots

    def take(a):  # (T, L, ...) in packed order, zero past the live leaves
        a = np.take_along_axis(a, order.reshape(order.shape + (1,) * (a.ndim - 2)), axis=1)
        return np.where(kept.reshape(kept.shape + (1,) * (a.ndim - 2)), a, 0)

    leaves = np.zeros((T, L, W + 1, 2), np.int32)
    leaves[:, :, :W, 0] = take(words(left)).view(np.int32)
    leaves[:, :, :W, 1] = take(words(right)).view(np.int32)
    leaves[:, :, W, 0] = take(V.view(np.int32))
    leaves[:, :, W, 1] = np.where(kept, order, -1)

    tested = ((left | right) & live[:, None, :]).any(axis=2)  # (T, I)
    n_nodes = np.where(tested.any(axis=1), I - np.argmax(tested[:, ::-1], axis=1), 0)
    feature = np.where(per_node == 1, np.argmax(nz, axis=1), -1)
    nodes = np.stack([feature.astype(np.int32), B.view(np.int32)], axis=-1)
    counts = np.stack([n_nodes, n_live], axis=-1).astype(np.int32)
    return PackedGemmProgram(nodes, leaves, counts)


def launch_plan(Fx: int, T: int, I: int, L: int) -> tuple[bool, int]:
    """(x staged in shared memory, trees staged per pass) for x of width
    ``Fx`` and a packed program of ``T`` trees, ``I`` nodes and ``L``
    leaves. x is staged when its ``Fx`` columns and a zero column fit
    ``X_SMEM_LIMIT``; a wider x is read per node through L1.

    Trees staged per pass 0 names the wide path, taken past ``W_MAX``
    decision words or where one tree does not fit shared memory beside x:
    each row's decision words sit in shared memory and the packed records
    are read through L1. Raises only where those words alone exceed a
    block's shared memory (over 7,264 internal nodes a tree)."""
    W = decision_words(I)
    tree_bytes = 8 * (I + L * (W + 1) + 1)
    x_bytes = 4 * (Fx + 1) * XS
    stage_x = x_bytes <= X_SMEM_LIMIT
    if W <= W_MAX and tree_bytes + (x_bytes if stage_x else 0) <= SMEM_LIMIT:
        return stage_x, max(1, min(T, CHUNK_SMEM // tree_bytes))
    words_bytes = 4 * W * ROWS
    if words_bytes > SMEM_LIMIT:
        raise ValueError(f"tree_gemm: {I} internal nodes need {W} decision words a "
                         f"row, {words_bytes} bytes of shared memory per block")
    return stage_x and words_bytes + x_bytes <= SMEM_LIMIT, 0


def packed_on(A, B, C, D, V, device) -> PackedGemmProgram:
    """:func:`pack_gemm_program` of a program held as tensors, on ``device``
    (a host round trip: programs compiled by ``TensorProgram`` are packed
    once, at compile time, instead)."""
    arrays = pack_gemm_program(*(t.detach().cpu().numpy() for t in (A, B, C, D, V)))
    return PackedGemmProgram(*(torch.as_tensor(a, device=device) for a in arrays))


def tree_gemm(x, A, B, C, D, V, base: float, packed: PackedGemmProgram) -> torch.Tensor:
    """x:(N,Fx) f32 with Fx <= F; the program A:(T,F,I), B:(T,I), C:(T,I,L),
    D:(T,L), V:(T,L) f32 and ``packed``, its :func:`pack_gemm_program` as
    int32 tensors, all on one CUDA device, contiguous. Only ``packed`` is
    read by the kernel; A…V give the shapes it is checked against. Columns
    of A past x's width meet zeros (the inert rows of a padded program).
    Returns (N,) raw ensemble scores."""
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
    W = decision_words(I)
    for t, name, shape in ((packed.nodes, "nodes", (T, I, 2)),
                           (packed.leaves, "leaves", (T, L, W + 1, 2)),
                           (packed.counts, "counts", (T, 2))):
        _build.require(t, name, torch.int32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"tree_gemm: packed {name} is {tuple(t.shape)}, expected {shape}")
    stage_x, chunk = launch_plan(Fx, T, I, L)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    with torch.cuda.device(dev):
        err = _build.lib().raven_tree_gemm(
            x.data_ptr(), packed.nodes.data_ptr(), packed.leaves.data_ptr(),
            packed.counts.data_ptr(), out.data_ptr(), float(base),
            N, Fx, T, I, L, W, chunk, int(stage_x), _build.stream_ptr(dev),
        )
    _build.check("tree_gemm", err)
    _build.launched("tree_gemm")
    return out
