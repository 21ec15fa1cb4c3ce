"""Data-induced optimizations (paper §4.2).

Column min/max statistics induce range predicates that feed the same
interval-propagation machinery as §4.1 — if the data contains no instance
with ``age <= 60``, the corresponding subtree is dead and is pruned at
compile time.

With partitioned data, a *specialized model per partition* is compiled using
that partition's statistics; the LPredict node carries the per-partition
pipelines and execution dispatches on the partition column (MLtoSQL composes:
per-partition expressions are guarded by a CASE on the partition column).
"""
from __future__ import annotations

from repro_torch.core.ir import (
    LScan,
    PredictionQuery,
    TableStats,
    walk,
)
from repro_torch.core.rules.propagation import (
    Interval,
    fold_linear,
    propagate_intervals,
    prune_tree_ensemble,
)


def _constraints_from_stats(
    stats: TableStats, input_names: set[str], columns: dict | None = None
) -> dict[str, Interval]:
    src = columns if columns is not None else stats.columns
    return {
        c: Interval(cs.min, cs.max) for c, cs in src.items() if c in input_names
    }


def _specialize(pipeline, constraints: dict[str, Interval]):
    """Prune a pipeline copy under the given interval constraints."""
    pipe = pipeline.copy()
    if not constraints:
        return pipe
    ivs = propagate_intervals(pipe, constraints)
    for node in pipe.model_nodes():
        feat_ivs = ivs[node.inputs[0]]
        if node.op == "tree_ensemble":
            node.attrs["ensemble"] = prune_tree_ensemble(
                node.attrs["ensemble"], feat_ivs
            )
        else:
            w, b = fold_linear(node.attrs["weights"], node.attrs["bias"], feat_ivs)
            node.attrs["weights"] = w
            node.attrs["bias"] = b
    return pipe


def apply_data_induced(query: PredictionQuery) -> PredictionQuery:
    if not query.stats:
        return query
    scans = [n for n in walk(query.plan) if isinstance(n, LScan)]
    for pred in query.predict_nodes():
        input_names = set(pred.pipeline.input_names())
        # global min/max-induced predicates (from every scanned table)
        constraints: dict[str, Interval] = {}
        for scan in scans:
            st = query.stats.get(scan.table)
            if st is None:
                continue
            for c, iv in _constraints_from_stats(st, input_names).items():
                constraints[c] = constraints.get(c, Interval()).intersect(iv)
        pred.pipeline = _specialize(pred.pipeline, constraints)

        # per-partition specialized models (fact-table partitioning)
        for scan in scans:
            st = query.stats.get(scan.table)
            if st is None or not st.partitions:
                continue
            parts = []
            for p in st.partitions:
                pc = dict(constraints)
                for c, iv in _constraints_from_stats(
                    st, input_names, p.columns
                ).items():
                    pc[c] = pc.get(c, Interval()).intersect(iv)
                parts.append((p.key, _specialize(pred.pipeline, pc)))
            pred.partitioned = parts
            pred.partition_col = st.partition_col
            break
    return query
