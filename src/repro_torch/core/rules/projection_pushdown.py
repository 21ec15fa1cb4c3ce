"""Model-projection pushdown (paper §4.1, model-to-data).

Pass 1 — for every model node, detect unused features (trees: features used by
no internal node; linear: zero weights — L1 training and predicate-folding
both produce exact zeros), replace the model with a densified version, and
insert a FeatureExtractor selecting only the used features.

Pass 2 — push each FeatureExtractor towards the pipeline inputs until
fixpoint: through Concat (splitting per input segment; empty segments drop the
whole producer chain), through Scaler (slicing offset/scale), through
OneHotEncoder (slicing categories), composing with FeatureExtractors; stopping
at Normalizers (row-norms mix columns).

Finally the relational side is pruned: scans read only surviving columns,
joins carry only surviving dim columns, and FK joins whose dim columns are all
projected out are *eliminated* (the paper's largest wins on Expedia/Flights).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.ir import (
    LAggregate,
    LFilter,
    LJoin,
    LPredict,
    LProject,
    LScan,
    LogicalPlan,
    PredictionQuery,
)
from repro_torch.ml.pipeline import PipelineNode, TrainedPipeline
from repro_torch.relational.expr import columns_of


# ---------------------------------------------------------------------------
# Pass 1: densification
# ---------------------------------------------------------------------------


def _densify_models(pipe: TrainedPipeline) -> bool:
    changed = False
    for node in pipe.model_nodes():
        if node.op == "tree_ensemble":
            ens = node.attrs["ensemble"]
            used = ens.used_features()
            if len(used) >= ens.n_features:
                continue
            dense = ens.copy()
            remap = np.searchsorted(used, np.maximum(dense.feature, 0))
            dense.feature = np.where(dense.feature == -1, -1, remap)
            dense.n_features = len(used)
            node.attrs["ensemble"] = dense
            indices = used
        else:  # linear
            w = node.attrs["weights"]
            used = np.flatnonzero(w != 0.0)
            if len(used) >= len(w):
                continue
            node.attrs["weights"] = w[used]
            indices = used
        fe_out = f"{node.outputs[0]}__dense_in"
        pipe.nodes.insert(
            pipe.nodes.index(node),
            PipelineNode(
                "feature_extractor",
                [node.inputs[0]],
                [fe_out],
                {"indices": np.asarray(indices, dtype=np.int64)},
            ),
        )
        node.inputs = [fe_out]
        changed = True
    return changed


# ---------------------------------------------------------------------------
# Pass 2: pushdown to fixpoint
# ---------------------------------------------------------------------------


def _value_width(pipe: TrainedPipeline, producer: PipelineNode) -> list[int]:
    """Widths of a concat node's inputs (needed to split FE indices)."""
    widths = []
    for i in producer.inputs:
        p = pipe.producer_of(i)
        if p is None:  # graph input: single column
            widths.append(1)
        elif p.op == "one_hot":
            widths.append(len(p.attrs["categories"]))
        elif p.op == "scaler":
            widths.append(len(p.attrs["offset"]))
        elif p.op == "constant":
            widths.append(np.atleast_1d(np.asarray(p.attrs["value"])).shape[-1])
        elif p.op == "feature_extractor":
            widths.append(len(p.attrs["indices"]))
        elif p.op == "concat":
            widths.append(sum(_value_width(pipe, p)))
        elif p.op in ("normalizer", "label_encode"):
            q = pipe.producer_of(p.inputs[0])
            widths.append(
                1 if q is None else _value_width(pipe, q)[0]
                if q.op == "concat" else 1
            )
        else:
            raise ValueError(p.op)
    return widths


def _push_one(pipe: TrainedPipeline, fe: PipelineNode) -> bool:
    """Try to push one FeatureExtractor below its producer. True if changed."""
    src = fe.inputs[0]
    producer = pipe.producer_of(src)
    if producer is None:
        # graph input (single column)
        if len(fe.attrs["indices"]) == 0:
            return False  # handled by dead-input pruning
        if len(fe.attrs["indices"]) == 1 and int(fe.attrs["indices"][0]) == 0:
            _replace_value(pipe, fe.outputs[0], src)
            pipe.nodes.remove(fe)
            return True
        return False
    if len(pipe.consumers_of(src)) > 1:
        return False  # conservative: only sole-consumer pushes

    idx = np.asarray(fe.attrs["indices"], dtype=np.int64)

    if producer.op == "feature_extractor":
        producer.attrs = dict(producer.attrs)
        producer.attrs["indices"] = np.asarray(producer.attrs["indices"])[idx]
        _replace_value(pipe, fe.outputs[0], producer.outputs[0])
        pipe.nodes.remove(fe)
        return True

    if producer.op == "scaler":
        new_in = f"{producer.outputs[0]}__fe"
        pipe.nodes.insert(
            pipe.nodes.index(producer),
            PipelineNode(
                "feature_extractor", [producer.inputs[0]], [new_in],
                {"indices": idx},
            ),
        )
        producer.inputs = [new_in]
        producer.attrs = {
            "offset": np.asarray(producer.attrs["offset"])[idx],
            "scale": np.asarray(producer.attrs["scale"])[idx],
        }
        _replace_value(pipe, fe.outputs[0], producer.outputs[0])
        pipe.nodes.remove(fe)
        return True

    if producer.op == "one_hot":
        producer.attrs = {
            "categories": np.asarray(producer.attrs["categories"])[idx]
        }
        _replace_value(pipe, fe.outputs[0], producer.outputs[0])
        pipe.nodes.remove(fe)
        return True

    if producer.op == "constant":
        v = np.atleast_1d(np.asarray(producer.attrs["value"]))
        producer.attrs = {"value": v[idx]}
        _replace_value(pipe, fe.outputs[0], producer.outputs[0])
        pipe.nodes.remove(fe)
        return True

    if producer.op == "concat":
        widths = _value_width(pipe, producer)
        bounds = np.cumsum([0] + widths)
        new_inputs = []
        pos = pipe.nodes.index(producer)
        for k, inp in enumerate(producer.inputs):
            lo, hi = bounds[k], bounds[k + 1]
            sub = idx[(idx >= lo) & (idx < hi)] - lo
            if len(sub) == 0:
                continue  # segment entirely unused -> input dropped
            if len(sub) == widths[k] and np.array_equal(sub, np.arange(widths[k])):
                new_inputs.append(inp)  # full passthrough
            else:
                sub_name = f"{inp}__fe{k}"
                pipe.nodes.insert(
                    pos,
                    PipelineNode(
                        "feature_extractor", [inp], [sub_name],
                        {"indices": sub},
                    ),
                )
                pos += 1
                new_inputs.append(sub_name)
        producer.inputs = new_inputs
        _replace_value(pipe, fe.outputs[0], producer.outputs[0])
        pipe.nodes.remove(fe)
        return True

    return False  # normalizer / label_encode / models: not pushable


def _replace_value(pipe: TrainedPipeline, old: str, new: str) -> None:
    for n in pipe.nodes:
        n.inputs = [new if i == old else i for i in n.inputs]
    pipe.outputs = [new if o == old else o for o in pipe.outputs]


def apply_projection_pushdown(query: PredictionQuery) -> PredictionQuery:
    for pred in query.predict_nodes():
        pipe = pred.pipeline
        _densify_models(pipe)
        changed = True
        while changed:
            changed = False
            for node in list(pipe.nodes):
                if node.op == "feature_extractor" and node in pipe.nodes:
                    if _push_one(pipe, node):
                        changed = True
        pipe.prune_dead()
        pipe.toposort()
    prune_relational_columns(query)
    return query


# ---------------------------------------------------------------------------
# Relational-side pruning + join elimination
# ---------------------------------------------------------------------------


def prune_relational_columns(
    query: PredictionQuery, eliminate_joins: bool = True
) -> None:
    """Column pruning to the scans. ``eliminate_joins=False`` gives the
    vanilla-engine behaviour (Spark prunes columns but keeps FK joins — join
    elimination needs Raven's FK-integrity knowledge), used for the no-opt
    baseline."""
    query.plan = _prune(query.plan, set(), eliminate_joins)


def _prune(
    plan: LogicalPlan, required: set[str], eliminate_joins: bool = True
) -> LogicalPlan:
    if isinstance(plan, LAggregate):
        need = set(required) | {c for _, _, c in plan.aggs}
        plan.child = _prune(plan.child, need, eliminate_joins)
        return plan
    if isinstance(plan, LProject):
        plan.keep = [c for c in plan.keep if not required or c in required]
        need = set(plan.keep)
        for e in plan.exprs.values():
            need |= columns_of(e)
        plan.child = _prune(plan.child, need, eliminate_joins)
        return plan
    if isinstance(plan, LFilter):
        plan.child = _prune(plan.child, set(required) | columns_of(plan.expr), eliminate_joins)
        return plan
    if isinstance(plan, LPredict):
        need = (set(required) - set(plan.output_names)) | set(
            plan.pipeline.input_names()
        )
        if plan.partition_col:
            need.add(plan.partition_col)
        plan.child = _prune(plan.child, need, eliminate_joins)
        return plan
    if isinstance(plan, LJoin):
        dim_needed = [c for c in plan.dim_columns if c in required]
        if not dim_needed and plan.fk_integrity and eliminate_joins:
            return _prune(plan.child, set(required), eliminate_joins)  # join eliminated
        plan.dim_columns = dim_needed
        fact_need = (set(required) - set(dim_needed)) | {plan.fact_key}
        plan.child = _prune(plan.child, fact_need, eliminate_joins)
        return plan
    if isinstance(plan, LScan):
        cols = [c for c in plan.columns if c in required]
        if not cols:  # keep one column so row count survives
            cols = plan.columns[:1]
        plan.columns = cols
        return plan
    raise TypeError(type(plan))
