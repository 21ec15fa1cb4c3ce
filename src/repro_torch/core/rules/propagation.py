"""Interval/constant propagation through trained pipelines + model pruning.

This is the machinery behind BOTH paper §4.1 (predicate-based model pruning —
constraints come from WHERE clauses) and §4.2 (data-induced — constraints come
from min/max column statistics, globally or per partition). A constraint set
maps raw input columns to closed intervals ``[lo, hi]`` (equality = point
interval); propagation pushes them through featurizers to per-feature
intervals at each model node, which then prune trees / fold linear terms.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.ml.pipeline import TrainedPipeline
from repro_torch.ml.trees import LEAF, TreeEnsemble
from repro_torch.relational.expr import Bin, Col, Const, Expr

INF = math.inf


@dataclass(frozen=True)
class Interval:
    lo: float = -INF
    hi: float = INF

    @property
    def is_const(self) -> bool:
        return self.lo == self.hi and math.isfinite(self.lo)

    def intersect(self, o: "Interval") -> "Interval":
        return Interval(max(self.lo, o.lo), min(self.hi, o.hi))


TOP = Interval()


# ---------------------------------------------------------------------------
# Predicate extraction (WHERE conjunctions -> per-column intervals)
# ---------------------------------------------------------------------------

_FLIP = {"le": "ge", "lt": "gt", "ge": "le", "gt": "lt", "eq": "eq"}


def extract_constraints(expr: Expr) -> Optional[dict[str, Interval]]:
    """Extract per-column intervals from a conjunctive predicate.

    Returns None if the expression is not a conjunction of simple
    column-vs-literal comparisons (in which case no pruning is attempted —
    the optimization is conservative, as in the paper).
    """
    out: dict[str, Interval] = {}

    def visit(e: Expr) -> bool:
        if isinstance(e, Bin) and e.op == "and":
            return visit(e.a) and visit(e.b)
        if isinstance(e, Bin) and e.op == "ne":
            # an inequation carries no interval information, but it must not
            # reject the whole conjunction (sound: pruning with a superset
            # of the satisfying rows)
            return True
        if isinstance(e, Bin) and e.op in ("le", "lt", "ge", "gt", "eq"):
            from repro_torch.relational.expr import Param

            a, b, op = e.a, e.b, e.op
            if isinstance(a, Const) and isinstance(b, Col):
                a, b, op = b, a, _FLIP[op]
            if isinstance(a, Col) and isinstance(b, Param):
                return True  # value unknown until bind time: no interval info
            if not (isinstance(a, Col) and isinstance(b, Const)):
                return False
            v = float(b.value)
            iv = {
                "eq": Interval(v, v),
                "le": Interval(-INF, v),
                "lt": Interval(-INF, v),  # closed approx: sound for pruning
                "ge": Interval(v, INF),
                "gt": Interval(v, INF),
            }[op]
            out[a.name] = out.get(a.name, TOP).intersect(iv)
            return True
        return False

    return out if visit(expr) else None


def predicate_columns(expr: Expr) -> set[str]:
    from repro_torch.relational.expr import columns_of

    return columns_of(expr)


# ---------------------------------------------------------------------------
# Interval propagation through the pipeline graph
# ---------------------------------------------------------------------------


def propagate_intervals(
    pipeline: TrainedPipeline, constraints: dict[str, Interval]
) -> dict[str, list[Interval]]:
    """Per-value per-column intervals at every pipeline value."""
    vals: dict[str, list[Interval]] = {}
    for spec in pipeline.inputs:
        vals[spec.name] = [constraints.get(spec.name, TOP)]
    for node in pipeline.nodes:
        a = node.attrs
        if node.op == "concat":
            vals[node.outputs[0]] = [
                iv for i in node.inputs for iv in vals[i]
            ]
        elif node.op == "scaler":
            ivs = vals[node.inputs[0]]
            out = []
            for k, iv in enumerate(ivs):
                off, sc = float(a["offset"][k]), float(a["scale"][k])
                lo, hi = (iv.lo - off) * sc, (iv.hi - off) * sc
                if sc < 0:
                    lo, hi = hi, lo
                out.append(Interval(lo, hi))
            vals[node.outputs[0]] = out
        elif node.op == "one_hot":
            iv = vals[node.inputs[0]][0]
            cats = a["categories"]
            out = []
            for c in cats:
                c = float(c)
                if iv.is_const:
                    out.append(Interval(1.0, 1.0) if c == iv.lo else Interval(0.0, 0.0))
                elif c < iv.lo or c > iv.hi:
                    out.append(Interval(0.0, 0.0))
                else:
                    out.append(Interval(0.0, 1.0))
            vals[node.outputs[0]] = out
        elif node.op == "label_encode":
            iv = vals[node.inputs[0]][0]
            classes = a["classes"]
            if iv.is_const:
                code = float(np.searchsorted(classes, iv.lo))
                vals[node.outputs[0]] = [Interval(code, code)]
            else:
                vals[node.outputs[0]] = [Interval(0.0, float(len(classes) - 1))]
        elif node.op == "feature_extractor":
            ivs = vals[node.inputs[0]]
            vals[node.outputs[0]] = [ivs[int(i)] for i in a["indices"]]
        elif node.op == "constant":
            v = np.atleast_1d(np.asarray(a["value"], dtype=np.float64))
            vals[node.outputs[0]] = [Interval(float(x), float(x)) for x in v]
        elif node.op == "normalizer":
            ivs = vals[node.inputs[0]]
            # row-norm mixes columns; only fully-constant rows stay constant
            if all(iv.is_const for iv in ivs):
                from repro_torch.ml.featurizers import Normalizer

                row = np.asarray([iv.lo for iv in ivs])[None, :]
                out_row = Normalizer(a["norm"]).transform(row)[0]
                vals[node.outputs[0]] = [Interval(float(x), float(x)) for x in out_row]
            else:
                vals[node.outputs[0]] = [TOP] * len(ivs)
        elif node.op in ("tree_ensemble", "linear"):
            for o in node.outputs:
                vals[o] = [TOP]
        elif node.op == "python_udf":
            # opaque host callable: same column count as its input, but
            # nothing can be said about the values — every column goes TOP
            vals[node.outputs[0]] = [TOP] * len(vals[node.inputs[0]])
        else:
            raise ValueError(node.op)
    return vals


# ---------------------------------------------------------------------------
# Model pruning given per-feature intervals
# ---------------------------------------------------------------------------


def prune_tree_ensemble(
    ens: TreeEnsemble, feature_intervals: list[Interval]
) -> TreeEnsemble:
    """Rebuild the ensemble resolving statically-decidable splits.

    Split on feature f with threshold t: interval [lo,hi] ⇒
      hi <= t → always-left, lo > t → always-right.
    """
    feature, threshold, left, right, leaf_value = [], [], [], [], []

    def emit() -> int:
        feature.append(LEAF)
        threshold.append(0.0)
        left.append(0)
        right.append(0)
        leaf_value.append(0.0)
        return len(feature) - 1

    def rebuild(old: int) -> int:
        # iterative rebuild to dodge recursion limits on deep trees
        # returns new node id for old subtree root
        stack = [("visit", old, None, None)]
        result: dict[int, int] = {}
        while stack:
            action, node, parent_new, side = stack.pop()
            if action == "visit":
                f = int(ens.feature[node])
                if f == LEAF:
                    nid = emit()
                    leaf_value[nid] = float(ens.leaf_value[node])
                    result[node] = nid
                    _link(parent_new, side, nid)
                    continue
                iv = feature_intervals[f] if f < len(feature_intervals) else TOP
                t = float(ens.threshold[node])
                if iv.hi <= t:  # always left
                    stack.append(("visit", int(ens.left[node]), parent_new, side))
                elif iv.lo > t:  # always right
                    stack.append(("visit", int(ens.right[node]), parent_new, side))
                else:
                    nid = emit()
                    feature[nid] = f
                    threshold[nid] = t
                    result[node] = nid
                    _link(parent_new, side, nid)
                    stack.append(("visit", int(ens.right[node]), nid, "r"))
                    stack.append(("visit", int(ens.left[node]), nid, "l"))
        return result.get(old, len(feature) - 1)

    def _link(parent_new, side, nid):
        if parent_new is None:
            return
        if side == "l":
            left[parent_new] = nid
        else:
            right[parent_new] = nid

    offsets = [0]
    for sl in ens.tree_slices():
        rebuild(sl.start)
        offsets.append(len(feature))

    feat = np.asarray(feature, dtype=np.int64)
    idx = np.arange(len(feat))
    is_leaf = feat == LEAF
    return TreeEnsemble(
        feature=feat,
        threshold=np.asarray(threshold, dtype=np.float64),
        left=np.where(is_leaf, idx, np.asarray(left, dtype=np.int64)),
        right=np.where(is_leaf, idx, np.asarray(right, dtype=np.int64)),
        leaf_value=np.asarray(leaf_value, dtype=np.float64),
        tree_offsets=np.asarray(offsets, dtype=np.int64),
        tree_weight=ens.tree_weight.copy(),
        base_score=ens.base_score,
        post_transform=ens.post_transform,
        n_features=ens.n_features,
    )


def fold_linear(
    weights: np.ndarray, bias: float, feature_intervals: list[Interval]
) -> tuple[np.ndarray, float]:
    """Fold constant features into the bias (weights become exact zeros)."""
    w = weights.copy()
    b = float(bias)
    for k, iv in enumerate(feature_intervals[: len(w)]):
        if iv.is_const and w[k] != 0.0:
            b += w[k] * iv.lo
            w[k] = 0.0
    return w, b


def prune_leaves_by_output_predicate(
    ens: TreeEnsemble, satisfies
) -> TreeEnsemble:
    """Paper §4.1 output-predicate pruning (single-tree models).

    Subtrees in which NO leaf satisfies the output predicate collapse to one
    canonical failing leaf — rows landing there are filtered out anyway, so
    query results are preserved exactly while the tree shrinks.
    """
    assert ens.n_trees == 1, "output-predicate pruning targets single trees"
    sat = np.zeros(ens.n_nodes, dtype=bool)
    # leaves first, then propagate up (nodes are parent-before-child, so
    # reverse order visits children before parents)
    for i in range(ens.n_nodes - 1, -1, -1):
        if ens.feature[i] == LEAF:
            sat[i] = bool(satisfies(float(ens.leaf_value[i])))
        else:
            sat[i] = sat[ens.left[i]] or sat[ens.right[i]]

    feature, threshold, left, right, leaf_value = [], [], [], [], []

    def emit_leaf(v):
        feature.append(LEAF)
        threshold.append(0.0)
        left.append(len(feature) - 1)
        right.append(len(feature) - 1)
        leaf_value.append(v)
        return len(feature) - 1

    # find a canonical failing leaf value
    fail_vals = [
        float(ens.leaf_value[i])
        for i in range(ens.n_nodes)
        if ens.feature[i] == LEAF and not sat[i]
    ]
    fail_v = fail_vals[0] if fail_vals else float(ens.leaf_value[0])

    def build(old: int) -> int:
        if not sat[old]:
            return emit_leaf(fail_v)
        if ens.feature[old] == LEAF:
            return emit_leaf(float(ens.leaf_value[old]))
        nid = len(feature)
        feature.append(int(ens.feature[old]))
        threshold.append(float(ens.threshold[old]))
        left.append(0)
        right.append(0)
        leaf_value.append(0.0)
        l = build(int(ens.left[old]))
        r = build(int(ens.right[old]))
        left[nid] = l
        right[nid] = r
        return nid

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, ens.n_nodes * 4 + 1000))
    try:
        build(0)
    finally:
        sys.setrecursionlimit(old_limit)
    feat = np.asarray(feature, dtype=np.int64)
    idx = np.arange(len(feat))
    is_leaf = feat == LEAF
    return TreeEnsemble(
        feature=feat,
        threshold=np.asarray(threshold, dtype=np.float64),
        left=np.where(is_leaf, idx, np.asarray(left, dtype=np.int64)),
        right=np.where(is_leaf, idx, np.asarray(right, dtype=np.int64)),
        leaf_value=np.asarray(leaf_value, dtype=np.float64),
        tree_offsets=np.asarray([0, len(feat)], dtype=np.int64),
        tree_weight=ens.tree_weight.copy(),
        base_score=ens.base_score,
        post_transform=ens.post_transform,
        n_features=ens.n_features,
    )
