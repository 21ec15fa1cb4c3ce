"""Tree-based models: CART decision trees, random forests, gradient boosting.

Trained models are stored in a flattened, ONNX-TreeEnsemble-like array form
(:class:`TreeEnsemble`) which is the single representation consumed by

  * the interpreted "ML runtime" (vectorized level-stepping, numpy),
  * the optimizer rules (predicate-based pruning, densification),
  * the MLtoSQL compiler (nested CASE / jnp.where chains),
  * the MLtoDNN compiler (Hummingbird-style GEMM / gather tensor programs).

Training is exact greedy CART with quantile-binned candidate thresholds —
fast enough for the synthetic corpora used here, and producing trees with the
same structural statistics the paper's OpenML study reports (depth, #nodes,
unused-feature fraction).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

LEAF = -1  # sentinel feature id for leaf nodes


# ---------------------------------------------------------------------------
# Flattened ensemble representation
# ---------------------------------------------------------------------------


@dataclass
class TreeEnsemble:
    """Flattened forest. All node arrays are concatenated over trees.

    feature[i]   — split feature index, or LEAF (-1) for leaves
    threshold[i] — split threshold (go left iff x[f] <= t)
    left[i], right[i] — absolute child node ids (undefined for leaves)
    leaf_value[i] — per-node contribution (only meaningful at leaves)
    tree_offsets — start node id of each tree; len == n_trees + 1
    tree_weight  — per-tree multiplier (1/n_trees for RF mean, lr for GBDT)
    base_score   — added to the aggregated raw score
    post_transform — "none" | "logistic"
    n_features   — input feature dimensionality the trees index into
    """

    feature: np.ndarray
    threshold: np.ndarray
    left: np.ndarray
    right: np.ndarray
    leaf_value: np.ndarray
    tree_offsets: np.ndarray
    tree_weight: np.ndarray
    base_score: float
    post_transform: str
    n_features: int

    @property
    def n_trees(self) -> int:
        return len(self.tree_offsets) - 1

    @property
    def n_nodes(self) -> int:
        return len(self.feature)

    def tree_slices(self) -> list[slice]:
        return [
            slice(int(self.tree_offsets[t]), int(self.tree_offsets[t + 1]))
            for t in range(self.n_trees)
        ]

    def max_depth(self) -> int:
        """Max depth over trees (root = depth 0)."""
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        out = 0
        for sl in self.tree_slices():
            root = sl.start
            depth[root] = 0
            # nodes are emitted parent-before-child inside each tree
            for i in range(sl.start, sl.stop):
                if self.feature[i] != LEAF:
                    depth[self.left[i]] = depth[i] + 1
                    depth[self.right[i]] = depth[i] + 1
                    out = max(out, int(depth[i]) + 1)
        return out

    def depths(self) -> np.ndarray:
        """Per-tree max depth."""
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        out = []
        for sl in self.tree_slices():
            d = 0
            for i in range(sl.start, sl.stop):
                if self.feature[i] != LEAF:
                    depth[self.left[i]] = depth[i] + 1
                    depth[self.right[i]] = depth[i] + 1
                    d = max(d, int(depth[i]) + 1)
            out.append(d)
        return np.asarray(out, dtype=np.int32)

    def used_features(self) -> np.ndarray:
        """Sorted unique feature indices used by any internal node."""
        internal = self.feature[self.feature != LEAF]
        return np.unique(internal)

    def raw_scores(self, X: np.ndarray) -> np.ndarray:
        """Interpreted inference: vectorized gather-stepping, per-tree loop.

        This is the "ML runtime" execution path — intentionally op-at-a-time
        (one pass per tree) like a generic runtime would do, as opposed to the
        fused tensor programs produced by MLtoDNN.
        """
        # f32 features (thresholds live on the f32 grid — see _concat_trees)
        X = np.asarray(X, dtype=np.float32)
        n = X.shape[0]
        acc = np.full(n, self.base_score, dtype=np.float64)
        feature = self.feature
        threshold = self.threshold
        left = self.left
        right = self.right
        leaf_value = self.leaf_value
        for t, sl in enumerate(self.tree_slices()):
            node = np.full(n, sl.start, dtype=np.int64)
            active = feature[node] != LEAF
            while active.any():
                f = feature[node]
                go_left = X[np.arange(n), np.maximum(f, 0)] <= threshold[node]
                nxt = np.where(go_left, left[node], right[node])
                node = np.where(active, nxt, node)
                active = feature[node] != LEAF
            acc += self.tree_weight[t] * leaf_value[node]
        return acc

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        raw = self.raw_scores(X)
        if self.post_transform == "logistic":
            return 1.0 / (1.0 + np.exp(-raw))
        return raw

    def predict(self, X: np.ndarray) -> np.ndarray:
        p = self.decision_function(X)
        if self.post_transform == "logistic":
            return (p >= 0.5).astype(np.int64)
        return p

    def copy(self) -> "TreeEnsemble":
        return TreeEnsemble(
            feature=self.feature.copy(),
            threshold=self.threshold.copy(),
            left=self.left.copy(),
            right=self.right.copy(),
            leaf_value=self.leaf_value.copy(),
            tree_offsets=self.tree_offsets.copy(),
            tree_weight=self.tree_weight.copy(),
            base_score=self.base_score,
            post_transform=self.post_transform,
            n_features=self.n_features,
        )


def _concat_trees(
    trees: list[dict],
    tree_weight: np.ndarray,
    base_score: float,
    post_transform: str,
    n_features: int,
) -> TreeEnsemble:
    """Concatenate per-tree dict-of-arrays into one TreeEnsemble."""
    offsets = [0]
    for t in trees:
        offsets.append(offsets[-1] + len(t["feature"]))
    off = np.asarray(offsets, dtype=np.int64)
    feature = np.concatenate([t["feature"] for t in trees])
    threshold = np.concatenate([t["threshold"] for t in trees])
    left = np.concatenate(
        [t["left"] + off[i] for i, t in enumerate(trees)]
    )
    right = np.concatenate(
        [t["right"] + off[i] for i, t in enumerate(trees)]
    )
    leaf_value = np.concatenate([t["leaf_value"] for t in trees])
    # children of leaves point at themselves so gather-stepping is total
    is_leaf = feature == LEAF
    idx = np.arange(len(feature))
    left = np.where(is_leaf, idx, left).astype(np.int64)
    right = np.where(is_leaf, idx, right).astype(np.int64)
    return TreeEnsemble(
        feature=feature.astype(np.int64),
        # thresholds live on the f32 grid (stored f64): every execution path
        # — interpreted runtime, MLtoSQL f32 engine, MLtoDNN tensor programs —
        # then performs the *same* f32 comparison, so compiled plans flip no
        # predictions vs the runtime beyond genuine f32-feature ties
        threshold=threshold.astype(np.float32).astype(np.float64),
        left=left,
        right=right,
        leaf_value=leaf_value.astype(np.float64),
        tree_offsets=off,
        tree_weight=np.asarray(tree_weight, dtype=np.float64),
        base_score=float(base_score),
        post_transform=post_transform,
        n_features=int(n_features),
    )


# ---------------------------------------------------------------------------
# CART training
# ---------------------------------------------------------------------------


def _candidate_thresholds(col: np.ndarray, max_bins: int) -> np.ndarray:
    u = np.unique(col)
    if len(u) <= 1:
        return np.empty(0)
    if len(u) <= max_bins:
        return (u[:-1] + u[1:]) / 2.0
    qs = np.quantile(col, np.linspace(0, 1, max_bins + 1)[1:-1])
    return np.unique(qs)


def _best_split_gini(X, y, sample_idx, feat_idx, max_bins):
    """Best (feature, threshold, gain) under gini impurity for a node."""
    ys = y[sample_idx]
    n = len(ys)
    pos = ys.sum()
    parent_gini = 1.0 - (pos / n) ** 2 - ((n - pos) / n) ** 2
    best = (None, None, 0.0)
    for f in feat_idx:
        col = X[sample_idx, f]
        for t in _candidate_thresholds(col, max_bins):
            mask = col <= t
            nl = mask.sum()
            if nl == 0 or nl == n:
                continue
            pl = ys[mask].sum()
            pr = pos - pl
            nr = n - nl
            gl = 1.0 - (pl / nl) ** 2 - ((nl - pl) / nl) ** 2
            gr = 1.0 - (pr / nr) ** 2 - ((nr - pr) / nr) ** 2
            gain = parent_gini - (nl / n) * gl - (nr / n) * gr
            if gain > best[2] + 1e-12:
                best = (f, float(t), float(gain))
    return best


def _best_split_mse(X, g, h, sample_idx, feat_idx, max_bins, lam=1.0):
    """Best split by (gradient, hessian) gain — XGBoost-style objective."""
    gs = g[sample_idx]
    hs = h[sample_idx]
    G, H = gs.sum(), hs.sum()
    parent = G * G / (H + lam)
    best = (None, None, 0.0)
    for f in feat_idx:
        col = X[sample_idx, f]
        order = np.argsort(col, kind="stable")
        cg = np.cumsum(gs[order])
        ch = np.cumsum(hs[order])
        sorted_col = col[order]
        for t in _candidate_thresholds(col, max_bins):
            k = np.searchsorted(sorted_col, t, side="right")
            if k == 0 or k == len(sorted_col):
                continue
            Gl, Hl = cg[k - 1], ch[k - 1]
            Gr, Hr = G - Gl, H - Hl
            gain = Gl * Gl / (Hl + lam) + Gr * Gr / (Hr + lam) - parent
            if gain > best[2] + 1e-9:
                best = (f, float(t), float(gain))
    return best


def _grow_tree(
    X: np.ndarray,
    target,
    *,
    max_depth: int,
    min_samples_split: int,
    max_bins: int,
    rng: Optional[np.random.Generator],
    max_features: Optional[int],
    mode: str,  # "gini" (target=y) | "grad" (target=(g, h))
) -> dict:
    """Grow one tree; returns flattened arrays (parent emitted before child)."""
    n_features = X.shape[1]
    feature, threshold, left, right, leaf_value = [], [], [], [], []

    def new_node():
        feature.append(LEAF)
        threshold.append(0.0)
        left.append(0)
        right.append(0)
        leaf_value.append(0.0)
        return len(feature) - 1

    def leaf_val(sample_idx):
        if mode == "gini":
            y = target[sample_idx]
            return float(y.mean())  # P(class=1); caller binarizes
        g, h = target
        return float(g[sample_idx].sum() / (h[sample_idx].sum() + 1.0))

    def build(sample_idx, depth):
        node = new_node()
        done = (
            depth >= max_depth
            or len(sample_idx) < min_samples_split
        )
        if not done and mode == "gini":
            done = target[sample_idx].min() == target[sample_idx].max()
        if done:
            leaf_value[node] = leaf_val(sample_idx)
            return node
        if max_features is not None and max_features < n_features:
            feat_idx = rng.choice(n_features, size=max_features, replace=False)
        else:
            feat_idx = np.arange(n_features)
        if mode == "gini":
            f, t, gain = _best_split_gini(X, target, sample_idx, feat_idx, max_bins)
        else:
            g, h = target
            f, t, gain = _best_split_mse(X, g, h, sample_idx, feat_idx, max_bins)
        if f is None or gain <= 0.0:
            leaf_value[node] = leaf_val(sample_idx)
            return node
        mask = X[sample_idx, f] <= t
        feature[node] = int(f)
        threshold[node] = float(t)
        left[node] = build(sample_idx[mask], depth + 1)
        right[node] = build(sample_idx[~mask], depth + 1)
        return node

    idx = np.arange(X.shape[0])
    if rng is not None and max_features is None and mode == "gini":
        pass
    build(idx, 0)
    return {
        "feature": np.asarray(feature, dtype=np.int64),
        "threshold": np.asarray(threshold, dtype=np.float64),
        "left": np.asarray(left, dtype=np.int64),
        "right": np.asarray(right, dtype=np.int64),
        "leaf_value": np.asarray(leaf_value, dtype=np.float64),
    }


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


@dataclass
class DecisionTreeClassifier:
    """Binary CART classifier. Leaf value = P(y=1); post_transform='none'
    with a 0.5 decision threshold (scores are already probabilities)."""

    max_depth: int = 8
    min_samples_split: int = 2
    max_bins: int = 32
    ensemble: Optional[TreeEnsemble] = field(default=None, repr=False)

    def fit(self, X, y) -> "DecisionTreeClassifier":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        tree = _grow_tree(
            X,
            y,
            max_depth=self.max_depth,
            min_samples_split=self.min_samples_split,
            max_bins=self.max_bins,
            rng=None,
            max_features=None,
            mode="gini",
        )
        self.ensemble = _concat_trees(
            [tree], np.ones(1), 0.0, "none", X.shape[1]
        )
        return self

    def predict_proba(self, X) -> np.ndarray:
        return self.ensemble.decision_function(np.asarray(X, dtype=np.float64))

    def predict(self, X) -> np.ndarray:
        return (self.predict_proba(X) >= 0.5).astype(np.int64)


@dataclass
class RandomForestClassifier:
    n_estimators: int = 10
    max_depth: int = 8
    min_samples_split: int = 2
    max_bins: int = 32
    max_features: str = "sqrt"
    seed: int = 0
    ensemble: Optional[TreeEnsemble] = field(default=None, repr=False)

    def fit(self, X, y) -> "RandomForestClassifier":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        n = X.shape[0]
        mf = (
            max(1, int(np.sqrt(X.shape[1])))
            if self.max_features == "sqrt"
            else X.shape[1]
        )
        trees = []
        for _ in range(self.n_estimators):
            boot = rng.integers(0, n, size=n)
            trees.append(
                _grow_tree(
                    X[boot],
                    y[boot],
                    max_depth=self.max_depth,
                    min_samples_split=self.min_samples_split,
                    max_bins=self.max_bins,
                    rng=rng,
                    max_features=mf,
                    mode="gini",
                )
            )
        self.ensemble = _concat_trees(
            trees,
            np.full(self.n_estimators, 1.0 / self.n_estimators),
            0.0,
            "none",
            X.shape[1],
        )
        return self

    def predict_proba(self, X) -> np.ndarray:
        return self.ensemble.decision_function(np.asarray(X, dtype=np.float64))

    def predict(self, X) -> np.ndarray:
        return (self.predict_proba(X) >= 0.5).astype(np.int64)


@dataclass
class GradientBoostingClassifier:
    """Binary GBDT with logistic loss and Newton leaf values."""

    n_estimators: int = 20
    max_depth: int = 3
    learning_rate: float = 0.3
    min_samples_split: int = 2
    max_bins: int = 32
    subsample: float = 1.0
    seed: int = 0
    ensemble: Optional[TreeEnsemble] = field(default=None, repr=False)

    def fit(self, X, y) -> "GradientBoostingClassifier":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        rng = np.random.default_rng(self.seed)
        n = X.shape[0]
        p0 = np.clip(y.mean(), 1e-6, 1 - 1e-6)
        base = float(np.log(p0 / (1 - p0)))
        F = np.full(n, base)
        trees = []
        for _ in range(self.n_estimators):
            p = 1.0 / (1.0 + np.exp(-F))
            g = y - p
            h = p * (1 - p)
            if self.subsample < 1.0:
                sub = rng.random(n) < self.subsample
            else:
                sub = np.ones(n, dtype=bool)
            Xs = X[sub]
            tree = _grow_tree(
                Xs,
                (g[sub], h[sub]),
                max_depth=self.max_depth,
                min_samples_split=self.min_samples_split,
                max_bins=self.max_bins,
                rng=rng,
                max_features=None,
                mode="grad",
            )
            single = _concat_trees([tree], np.ones(1), 0.0, "none", X.shape[1])
            F = F + self.learning_rate * single.raw_scores(X)
            trees.append(tree)
        self.ensemble = _concat_trees(
            trees,
            np.full(self.n_estimators, self.learning_rate),
            base,
            "logistic",
            X.shape[1],
        )
        return self

    def predict_proba(self, X) -> np.ndarray:
        return self.ensemble.decision_function(np.asarray(X, dtype=np.float64))

    def predict(self, X) -> np.ndarray:
        return (self.predict_proba(X) >= 0.5).astype(np.int64)
