"""Tree ensembles → tensor programs (two strategies, as in Hummingbird).

GEMM strategy: trees become three dense contractions

    S = X · A          (N,F)·(T,F,I) -> (N,T,I)   split-feature values
    D = (S <= B)                                   decisions
    P = D · C          (N,T,I)·(T,I,L) -> (N,T,L)  path scores
    leaf = (P == Dcount)                           exact-path match
    y = Σ_t leaf · V   + base

All shapes are padded: I (internal nodes) and L (leaves) to the ensemble max
(and further by ``kernels.ops.pad_gemm_program`` for the CUDA kernel).

Traversal strategy — iterative gather-stepping over padded node arrays
(better for deep/narrow trees where the GEMM's O(F·I + I·L) work explodes).
The runtime-selection corpus (paper §5.2) learns the crossover.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.ml.trees import LEAF, TreeEnsemble


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class GemmTreeProgram:
    A: np.ndarray  # (T, F, I) f32
    B: np.ndarray  # (T, I)    f32 thresholds
    C: np.ndarray  # (T, I, L) f32 in {-1,0,1}
    Dcount: np.ndarray  # (T, L) f32 — left-ancestor counts per leaf
    V: np.ndarray  # (T, L) f32 — leaf values × tree weight
    base: float
    post: str
    n_features: int

    @property
    def padded_dims(self) -> tuple[int, int, int]:
        return self.A.shape[1], self.A.shape[2], self.C.shape[2]


def build_gemm_program(
    ens: TreeEnsemble, pad_to: int = 8
) -> GemmTreeProgram:
    slices = ens.tree_slices()
    T = ens.n_trees
    # per-tree internal/leaf enumeration
    internals, leaves = [], []
    for sl in slices:
        ids = np.arange(sl.start, sl.stop)
        internals.append(ids[ens.feature[sl] != LEAF])
        leaves.append(ids[ens.feature[sl] == LEAF])
    I = _round_up(max(max(len(i) for i in internals), 1), pad_to)
    L = _round_up(max(max(len(l) for l in leaves), 1), pad_to)
    F = ens.n_features

    A = np.zeros((T, F, I), dtype=np.float32)
    B = np.full((T, I), np.float32(np.inf))  # padded nodes: x<=inf -> left, harmless
    C = np.zeros((T, I, L), dtype=np.float32)
    Dc = np.full((T, L), np.float32(-1.0))  # padded leaves can never match
    V = np.zeros((T, L), dtype=np.float32)

    for t, sl in enumerate(slices):
        int_ids = {int(n): k for k, n in enumerate(internals[t])}
        leaf_ids = {int(n): k for k, n in enumerate(leaves[t])}
        for n, k in int_ids.items():
            A[t, int(ens.feature[n]), k] = 1.0
            B[t, k] = np.float32(ens.threshold[n])
        w = float(ens.tree_weight[t])
        for n, l in leaf_ids.items():
            V[t, l] = np.float32(w * ens.leaf_value[n])
        # ancestor walk: root-to-leaf paths
        def paths(node, acc, t=t):
            if ens.feature[node] == LEAF:
                l = leaf_ids[int(node)]
                Dc[t, l] = np.float32(sum(1 for _, d in acc if d == 1))
                for anc, d in acc:
                    C[t, int_ids[anc], l] = np.float32(1.0 if d == 1 else -1.0)
                return
            paths(int(ens.left[node]), acc + [(int(node), 1)])
            paths(int(ens.right[node]), acc + [(int(node), 0)])

        import sys

        lim = sys.getrecursionlimit()
        sys.setrecursionlimit(max(lim, (sl.stop - sl.start) * 4 + 100))
        try:
            paths(sl.start, [])
        finally:
            sys.setrecursionlimit(lim)

    return GemmTreeProgram(
        A=A, B=B, C=C, Dcount=Dc, V=V,
        base=float(ens.base_score),
        post=ens.post_transform,
        n_features=F,
    )


def _on(a, device) -> torch.Tensor:
    """A program array as a tensor on ``device`` (a no-op for the buffers a
    compiled program already holds there)."""
    return torch.as_tensor(a, device=device)


def gemm_predict(prog: GemmTreeProgram, X: torch.Tensor) -> torch.Tensor:
    """Plain-torch GEMM-strategy inference. ``prog``'s arrays may be numpy
    or tensors; ``A`` may be padded past X's width (zero rows are inert)."""
    dev = X.device
    A = _on(prog.A, dev)
    X = X.to(torch.float32)
    if A.shape[1] > X.shape[1]:
        X = torch.nn.functional.pad(X, (0, A.shape[1] - X.shape[1]))
    S = torch.einsum("nf,tfi->nti", X, A)
    D = (S <= _on(prog.B, dev)[None]).to(torch.float32)
    P = torch.einsum("nti,til->ntl", D, _on(prog.C, dev))
    match = (P == _on(prog.Dcount, dev)[None]).to(torch.float32)
    raw = torch.einsum("ntl,tl->n", match, _on(prog.V, dev)) + prog.base
    return raw


@dataclass
class TraversalTreeProgram:
    feature: np.ndarray  # (T, Nmax) int32, -1 for leaf (self-looping children)
    threshold: np.ndarray  # (T, Nmax) f32
    left: np.ndarray  # (T, Nmax) int32 (tree-local)
    right: np.ndarray  # (T, Nmax) int32
    leaf_value: np.ndarray  # (T, Nmax) f32 (× tree weight)
    max_depth: int
    base: float
    post: str
    n_features: int


def build_traversal_program(ens: TreeEnsemble) -> TraversalTreeProgram:
    slices = ens.tree_slices()
    T = ens.n_trees
    Nmax = max(sl.stop - sl.start for sl in slices)
    feature = np.full((T, Nmax), -1, dtype=np.int32)
    threshold = np.zeros((T, Nmax), dtype=np.float32)
    left = np.zeros((T, Nmax), dtype=np.int32)
    right = np.zeros((T, Nmax), dtype=np.int32)
    leaf_value = np.zeros((T, Nmax), dtype=np.float32)
    for t, sl in enumerate(slices):
        n = sl.stop - sl.start
        feature[t, :n] = ens.feature[sl]
        threshold[t, :n] = ens.threshold[sl]
        left[t, :n] = ens.left[sl] - sl.start
        right[t, :n] = ens.right[sl] - sl.start
        w = float(ens.tree_weight[t])
        leaf_value[t, :n] = w * ens.leaf_value[sl]
        # leaves self-loop (already true in TreeEnsemble, re-localized)
        is_leaf = feature[t, :n] == -1
        idx = np.arange(n, dtype=np.int32)
        left[t, :n] = np.where(is_leaf, idx, left[t, :n])
        right[t, :n] = np.where(is_leaf, idx, right[t, :n])
    return TraversalTreeProgram(
        feature=feature,
        threshold=threshold,
        left=left,
        right=right,
        leaf_value=leaf_value,
        max_depth=int(ens.max_depth()),
        base=float(ens.base_score),
        post=ens.post_transform,
        n_features=ens.n_features,
    )


def traversal_predict(prog: TraversalTreeProgram, X: torch.Tensor) -> torch.Tensor:
    """Vectorized gather-stepping over (batch × trees): a Python loop over
    depth, each step one gather of the current nodes' split features."""
    dev = X.device
    X = X.to(torch.float32)
    n = X.shape[0]
    feature = _on(prog.feature, dev)
    threshold = _on(prog.threshold, dev)
    left = _on(prog.left, dev)
    right = _on(prog.right, dev)
    leaf_value = _on(prog.leaf_value, dev)
    T = feature.shape[0]
    t_idx = torch.arange(T, device=dev)[None, :]  # broadcast over batch
    node = torch.zeros((n, T), dtype=torch.int64, device=dev)
    for _ in range(max(prog.max_depth, 1)):
        f = feature[t_idx, node]  # (n, T)
        thr = threshold[t_idx, node]
        xv = torch.gather(X, 1, f.clamp(min=0).to(torch.int64))  # (n, T)
        go_left = xv <= thr
        node = torch.where(go_left, left[t_idx, node], right[t_idx, node]).to(
            torch.int64
        )
    return leaf_value[t_idx, node].sum(dim=1) + prog.base
