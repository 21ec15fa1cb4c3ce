"""Predicate-based model pruning (paper §4.1, data-to-model).

Step 1 — collect the model's inputs that participate in WHERE predicates
*below* the predict node; equality-constrained inputs are replaced by constant
nodes inside the pipeline (the column then no longer needs to reach the model
— projection pushdown will later remove it from scans/joins entirely).

Step 2 — push the equality/range information through featurizers via interval
propagation and prune each tree-based model / fold each linear model.

Also handles predicates on pipeline *outputs* (filters above the predict
node): for single-tree models, subtrees with no satisfying leaf collapse.
"""
from __future__ import annotations


import numpy as np

from repro_torch.core.ir import (
    LFilter,
    LPredict,
    LogicalPlan,
    PredictionQuery,
    children,
    walk,
)
from repro_torch.core.rules.propagation import (
    Interval,
    extract_constraints,
    fold_linear,
    propagate_intervals,
    prune_leaves_by_output_predicate,
    prune_tree_ensemble,
)
from repro_torch.ml.pipeline import PipelineNode
from repro_torch.relational.expr import Bin, Col, Const, Expr


def _filters_below(plan: LogicalPlan, target: LPredict) -> list[Expr]:
    """Filter expressions on the path below ``target``."""
    out = []
    for node in walk(target.child):
        if isinstance(node, LFilter):
            out.append(node.expr)
    return out


def _filters_above(plan: LogicalPlan, target: LPredict) -> list[LFilter]:
    """Filter nodes between the root and ``target`` (exclusive)."""
    out = []

    def descend(p: LogicalPlan) -> bool:
        if p is target:
            return True
        found = any(descend(c) for c in children(p))
        if found and isinstance(p, LFilter):
            out.append(p)
        return found

    descend(plan)
    return out


def apply_predicate_pruning(query: PredictionQuery) -> PredictionQuery:
    for pred in query.predict_nodes():
        pipe = pred.pipeline
        constraints: dict[str, Interval] = {}
        for expr in _filters_below(query.plan, pred):
            c = extract_constraints(expr)
            if c:
                for col, iv in c.items():
                    constraints[col] = constraints.get(col, Interval()).intersect(iv)
        input_names = set(pipe.input_names())
        relevant = {k: v for k, v in constraints.items() if k in input_names}

        # --- step 1: equality predicates -> constant nodes -----------------
        for col, iv in relevant.items():
            if iv.is_const:
                pipe.inputs = [s for s in pipe.inputs if s.name != col]
                pipe.nodes.insert(
                    0,
                    PipelineNode(
                        "constant", [], [col], {"value": np.asarray([iv.lo])}
                    ),
                )

        # --- step 2: interval propagation + model pruning ------------------
        if relevant:
            ivs = propagate_intervals(pipe, relevant)
            for node in pipe.model_nodes():
                feat_ivs = ivs[node.inputs[0]]
                if node.op == "tree_ensemble":
                    node.attrs["ensemble"] = prune_tree_ensemble(
                        node.attrs["ensemble"], feat_ivs
                    )
                elif node.op == "linear":
                    w, b = fold_linear(
                        node.attrs["weights"], node.attrs["bias"], feat_ivs
                    )
                    node.attrs["weights"] = w
                    node.attrs["bias"] = b

        # --- output predicates (paper: leaf-level pruning) ------------------
        for f in _filters_above(query.plan, pred):
            sat = _satisfier(f.expr, pred)
            if sat is None:
                continue
            for node in pipe.model_nodes():
                if node.op == "tree_ensemble" and node.attrs["ensemble"].n_trees == 1:
                    node.attrs["ensemble"] = prune_leaves_by_output_predicate(
                        node.attrs["ensemble"], sat
                    )
        pipe.toposort()
    return query


def _satisfier(expr: Expr, pred: LPredict):
    """Build leaf-value -> bool for simple output predicates.

    Supports ``<label_col> = k`` and ``<score_col> {>=,>,<=,<} c`` on a
    tree model whose score is the leaf value (post_transform handled).
    """
    if not (isinstance(expr, Bin) and isinstance(expr.a, Col) and isinstance(expr.b, Const)):
        return None
    col, op, v = expr.a.name, expr.op, float(expr.b.value)
    outs = pred.output_names
    model = pred.pipeline.model_nodes()
    if not model:
        return None
    node = model[0]
    post = (
        node.attrs["ensemble"].post_transform
        if node.op == "tree_ensemble"
        else node.attrs.get("post", "none")
    )
    thr = node.attrs.get("decision_threshold", 0.5)

    def transform(leaf):
        return 1.0 / (1.0 + np.exp(-leaf)) if post == "logistic" else leaf

    if len(outs) > 1 and col == outs[1] and op == "eq":  # label predicate
        want = int(v)
        return lambda leaf: int(transform(leaf) >= thr) == want
    if col == outs[0]:  # score predicate
        return {
            "ge": lambda leaf: transform(leaf) >= v,
            "gt": lambda leaf: transform(leaf) > v,
            "le": lambda leaf: transform(leaf) <= v,
            "lt": lambda leaf: transform(leaf) < v,
        }.get(op)
    return None
