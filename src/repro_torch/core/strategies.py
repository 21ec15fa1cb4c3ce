"""Data-driven optimization strategies for runtime selection (paper §5.2).

Three strategies choose between {none, sql, dnn} per predict node:

  * ML-informed rule-based — train a deep multiclass tree on the corpus, take
    its top-k features, retrain a shallow tree, and *render it as a rule*
    (no model invocation at optimization time; deployable as code).
  * Classification-based — random forest over the 22 pipeline statistics
    predicting the best transformation directly.
  * Regression-based — a regression tree predicts log-runtime with the
    transformation as an input feature (3× the training data); pick argmin.

The corpus is measured on *this* hardware/backends (the paper's own
prescription: users re-train the strategy for their workload and setup).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.stats import STAT_NAMES
from repro_torch.ml.trees import _candidate_thresholds, _concat_trees, _grow_tree

TRANSFORMS = ("none", "sql", "dnn")


# ---------------------------------------------------------------------------
# Multiclass CART (gini) — used by the rule-based & classification strategies
# ---------------------------------------------------------------------------


def _gini(counts: np.ndarray) -> float:
    n = counts.sum()
    if n == 0:
        return 0.0
    p = counts / n
    return float(1.0 - (p * p).sum())


@dataclass
class MulticlassTreeClassifier:
    max_depth: int = 6
    min_samples_split: int = 2
    max_bins: int = 16
    max_features: Optional[int] = None
    seed: int = 0
    nodes: list = field(default_factory=list, repr=False)  # (f,t,l,r,counts)
    classes_: Optional[np.ndarray] = None
    importances_: Optional[np.ndarray] = None

    def fit(self, X, y, sample_idx=None):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y)
        self.classes_, yi = np.unique(y, return_counts=False), None
        yi = np.searchsorted(self.classes_, y)
        K = len(self.classes_)
        rng = np.random.default_rng(self.seed)
        self.nodes = []
        self.importances_ = np.zeros(X.shape[1])
        idx = np.arange(X.shape[0]) if sample_idx is None else sample_idx

        def counts_of(ii):
            return np.bincount(yi[ii], minlength=K).astype(np.float64)

        def build(ii, depth):
            node_id = len(self.nodes)
            c = counts_of(ii)
            self.nodes.append([-1, 0.0, 0, 0, c])
            if (
                depth >= self.max_depth
                or len(ii) < self.min_samples_split
                or (c > 0).sum() <= 1
            ):
                return node_id
            gp = _gini(c)
            feats = (
                rng.choice(X.shape[1], self.max_features, replace=False)
                if self.max_features and self.max_features < X.shape[1]
                else np.arange(X.shape[1])
            )
            best = (None, None, 1e-12)
            for f in feats:
                col = X[ii, f]
                for t in _candidate_thresholds(col, self.max_bins):
                    m = col <= t
                    cl, cr = counts_of(ii[m]), counts_of(ii[~m])
                    nl, nr = cl.sum(), cr.sum()
                    if nl == 0 or nr == 0:
                        continue
                    gain = gp - (nl * _gini(cl) + nr * _gini(cr)) / len(ii)
                    if gain > best[2]:
                        best = (int(f), float(t), float(gain))
            f, t, gain = best
            if f is None:
                return node_id
            self.importances_[f] += gain * len(ii)
            m = X[ii, f] <= t
            self.nodes[node_id][0] = f
            self.nodes[node_id][1] = t
            self.nodes[node_id][2] = build(ii[m], depth + 1)
            self.nodes[node_id][3] = build(ii[~m], depth + 1)
            return node_id

        build(idx, 0)
        s = self.importances_.sum()
        if s > 0:
            self.importances_ /= s
        return self

    def predict(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(len(X), dtype=self.classes_.dtype)
        for i, row in enumerate(X):
            n = 0
            while self.nodes[n][0] != -1:
                f, t, l, r, _ = self.nodes[n]
                n = l if row[f] <= t else r
            out[i] = self.classes_[int(np.argmax(self.nodes[n][4]))]
        return out

    def predict_proba(self, X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.zeros((len(X), len(self.classes_)))
        for i, row in enumerate(X):
            n = 0
            while self.nodes[n][0] != -1:
                f, t, l, r, _ = self.nodes[n]
                n = l if row[f] <= t else r
            c = self.nodes[n][4]
            out[i] = c / max(c.sum(), 1.0)
        return out


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------


@dataclass
class RuleBasedStrategy:
    """Deep tree → top-k features → shallow tree → human-readable rule."""

    k: int = 3
    shallow_depth: int = 2
    tree: Optional[MulticlassTreeClassifier] = field(default=None, repr=False)
    top_features: Optional[np.ndarray] = None

    def fit(self, X, y):
        deep = MulticlassTreeClassifier(max_depth=8).fit(X, y)
        self.top_features = np.argsort(deep.importances_)[::-1][: self.k]
        self.tree = MulticlassTreeClassifier(max_depth=self.shallow_depth).fit(
            X[:, self.top_features], y
        )
        return self

    def choose(self, stats: np.ndarray) -> str:
        lab = self.tree.predict(stats[None, self.top_features])[0]
        return TRANSFORMS[int(lab)]

    def describe(self) -> str:
        """Render the learned rule as nested if/else over stat names."""
        lines: list[str] = []

        def render(n, indent):
            f, t, l, r, c = self.tree.nodes[n]
            pad = "  " * indent
            if f == -1:
                lines.append(
                    f"{pad}apply {TRANSFORMS[int(np.argmax(c))].upper()}"
                )
                return
            name = STAT_NAMES[int(self.top_features[f])]
            lines.append(f"{pad}if {name} <= {t:.3g}:")
            render(l, indent + 1)
            lines.append(f"{pad}else:")
            render(r, indent + 1)

        render(0, 0)
        return "\n".join(lines)


@dataclass
class ClassificationStrategy:
    """Random forest over pipeline statistics (paper's best performer)."""

    n_estimators: int = 25
    max_depth: int = 8
    seed: int = 0
    trees: list = field(default_factory=list, repr=False)

    def fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        n, d = np.asarray(X).shape
        mf = max(1, int(np.sqrt(d)))
        self.trees = []
        for i in range(self.n_estimators):
            boot = rng.integers(0, n, size=n)
            t = MulticlassTreeClassifier(
                max_depth=self.max_depth, max_features=mf, seed=i
            ).fit(np.asarray(X)[boot], np.asarray(y)[boot])
            self.trees.append(t)
        return self

    def choose(self, stats: np.ndarray) -> str:
        votes = np.zeros(len(TRANSFORMS))
        for t in self.trees:
            p = t.predict_proba(stats[None])[0]
            for ci, cls in enumerate(t.classes_):
                votes[int(cls)] += p[ci]
        return TRANSFORMS[int(np.argmax(votes))]


@dataclass
class RegressionStrategy:
    """Regression tree over [stats ⊕ onehot(transform)] → log runtime."""

    max_depth: int = 8
    ensemble: object = field(default=None, repr=False)

    @staticmethod
    def _augment(X: np.ndarray, transform_ids: np.ndarray) -> np.ndarray:
        oh = np.eye(len(TRANSFORMS))[transform_ids]
        return np.concatenate([X, oh], axis=1)

    def fit(self, X, y_runtimes):
        """X: (n, 22); y_runtimes: (n, 3) measured runtime per transform."""
        X = np.asarray(X, dtype=np.float64)
        rows, targets = [], []
        for i in range(len(X)):
            for tid in range(len(TRANSFORMS)):
                rows.append(self._augment(X[i : i + 1], np.asarray([tid]))[0])
                targets.append(np.log(max(y_runtimes[i, tid], 1e-9)))
        Xa = np.asarray(rows)
        ya = np.asarray(targets)
        # Grow the tree on mean-centered targets: the grad-mode split gain
        # G²/(H+λ) is regularized, so a large common offset (log-runtimes sit
        # far from 0) makes every split cost ~μ² and the tree degenerates to
        # a single leaf. The mean becomes the ensemble's base_score.
        base = float(ya.mean())
        tree = _grow_tree(
            Xa,
            (ya - base, np.ones_like(ya)),
            max_depth=self.max_depth,
            min_samples_split=2,
            max_bins=32,
            rng=None,
            max_features=None,
            mode="grad",
        )
        self.ensemble = _concat_trees([tree], np.ones(1), base, "none", Xa.shape[1])
        return self

    def choose(self, stats: np.ndarray) -> str:
        preds = []
        for tid in range(len(TRANSFORMS)):
            row = self._augment(stats[None], np.asarray([tid]))
            preds.append(float(self.ensemble.raw_scores(row)[0]))
        return TRANSFORMS[int(np.argmin(preds))]


# ---------------------------------------------------------------------------
# Evaluation harness (paper Fig. 4)
# ---------------------------------------------------------------------------


def evaluate_strategy(strategy, X_test, y_test, runtimes_test) -> dict:
    """Accuracy + speedup-vs-optimal over a held-out corpus fold."""
    chosen = np.asarray(
        [TRANSFORMS.index(strategy.choose(x)) for x in np.asarray(X_test)]
    )
    acc = float((chosen == np.asarray(y_test)).mean())
    opt_time = runtimes_test[np.arange(len(chosen)), np.asarray(y_test)].sum()
    got_time = runtimes_test[np.arange(len(chosen)), chosen].sum()
    return {"accuracy": acc, "speedup_vs_optimal": float(opt_time / got_time)}
