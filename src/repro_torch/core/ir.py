"""Raven's unified IR.

One DAG captures *both* the relational spine of a prediction query (scans,
joins, filters, projections, aggregates) and the ML part — each ``LPredict``
node holds a full :class:`~repro_torch.ml.pipeline.TrainedPipeline` whose internal
featurizer/model nodes are first-class IR citizens the rules rewrite
(the paper bases its IR on ONNX extended with relational operators; we do the
same — ``TrainedPipeline`` is our ONNX analog, and the relational nodes below
extend it).

Statistics (`TableStats`) ride along for the data-induced optimizations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Union

import numpy as np

from repro_torch.core.fingerprint import fingerprint
from repro_torch.ml.pipeline import TrainedPipeline
from repro_torch.relational.expr import Expr


# ---------------------------------------------------------------------------
# Data statistics (paper §4.2)
# ---------------------------------------------------------------------------


@dataclass
class ColumnStats:
    min: float
    max: float
    distinct: Optional[np.ndarray] = None  # small-cardinality domains only

    @staticmethod
    def of(col: np.ndarray, max_distinct: int = 64) -> "ColumnStats":
        u = np.unique(col)
        return ColumnStats(
            min=float(u[0]),
            max=float(u[-1]),
            distinct=u if len(u) <= max_distinct else None,
        )


@dataclass
class PartitionStats:
    """One data partition (paper: user-specified or group-by induced)."""

    key: Any  # partition identity (e.g. partition-column value)
    n_rows: int
    columns: dict[str, ColumnStats]


@dataclass
class TableStats:
    n_rows: int
    columns: dict[str, ColumnStats]
    partition_col: Optional[str] = None
    partitions: list[PartitionStats] = field(default_factory=list)

    @staticmethod
    def of(
        table: dict[str, np.ndarray], partition_col: Optional[str] = None
    ) -> "TableStats":
        cols = {c: ColumnStats.of(v) for c, v in table.items()}
        n = len(next(iter(table.values())))
        parts: list[PartitionStats] = []
        if partition_col is not None:
            for key in np.unique(table[partition_col]):
                mask = table[partition_col] == key
                parts.append(
                    PartitionStats(
                        key=key,
                        n_rows=int(mask.sum()),
                        columns={
                            c: ColumnStats.of(v[mask]) for c, v in table.items()
                        },
                    )
                )
        return TableStats(
            n_rows=n, columns=cols, partition_col=partition_col, partitions=parts
        )


# ---------------------------------------------------------------------------
# Logical operators
# ---------------------------------------------------------------------------


@dataclass
class LScan:
    table: str
    columns: list[str]


@dataclass
class LJoin:
    child: "LogicalPlan"
    dim_table: str
    fact_key: str
    dim_key: str
    dim_columns: list[str]
    fk_integrity: bool = True  # FK joins are non-filtering -> eliminable


@dataclass
class LFilter:
    child: "LogicalPlan"
    expr: Expr


@dataclass
class LProject:
    child: "LogicalPlan"
    keep: list[str]
    exprs: dict[str, Expr] = field(default_factory=dict)


@dataclass
class LPredict:
    """Trained-pipeline invocation. ``output_names`` aliases the pipeline's
    graph outputs as columns (e.g. score -> 'score', label -> 'pred').

    ``transform`` records the physical decision (§5): None until the
    optimizer's strategy sets it to one of {'none','sql','dnn'}.
    ``partitioned`` carries per-partition specialized pipelines from the
    data-induced rule.
    """

    child: "LogicalPlan"
    pipeline: TrainedPipeline
    output_names: list[str]
    transform: Optional[str] = None
    partitioned: Optional[list[tuple[Any, TrainedPipeline]]] = None
    partition_col: Optional[str] = None
    # MLtoSQL only: emit the score in probability space (sigmoid applied)
    # because the score column is visible in the query result; otherwise the
    # faster logit-space emission + filter rewrite is used.
    emit_prob: bool = False


@dataclass
class LAggregate:
    child: "LogicalPlan"
    aggs: list[tuple[str, str, str]]


LogicalPlan = Union[LScan, LJoin, LFilter, LProject, LPredict, LAggregate]


def children(p: LogicalPlan) -> list[LogicalPlan]:
    return [] if isinstance(p, LScan) else [p.child]


def walk(p: LogicalPlan):
    yield p
    for c in children(p):
        yield from walk(c)


def plan_fingerprint(p: LogicalPlan, pins: Optional[list] = None) -> str:
    """Canonical content hash of a logical plan (operators, expressions,
    pipeline weights). Structurally identical plans hash equal."""
    return fingerprint(p, pins=pins)


def plan_params(p: LogicalPlan) -> set[str]:
    """Names of every ``:param`` placeholder the logical plan references."""
    from repro_torch.relational.expr import params_of

    names: set[str] = set()
    for node in walk(p):
        if isinstance(node, LFilter):
            names |= params_of(node.expr)
        elif isinstance(node, LProject):
            for e in node.exprs.values():
                names |= params_of(e)
    return names


def format_logical_plan(p: LogicalPlan, indent: int = 0) -> str:
    """Indented one-node-per-line rendering of a logical plan (EXPLAIN)."""
    from repro_torch.relational.expr import format_expr

    pad = "  " * indent
    if isinstance(p, LScan):
        cols = ", ".join(p.columns)
        line = f"{pad}Scan[{p.table}] cols=({cols})"
        return line
    if isinstance(p, LJoin):
        line = (
            f"{pad}Join[{p.dim_table}] on {p.fact_key}={p.dim_key} "
            f"bring=({', '.join(p.dim_columns)})"
        )
        return line + "\n" + format_logical_plan(p.child, indent + 1)
    if isinstance(p, LFilter):
        line = f"{pad}Filter[{format_expr(p.expr)}]"
        return line + "\n" + format_logical_plan(p.child, indent + 1)
    if isinstance(p, LProject):
        exprs = ", ".join(f"{k}={format_expr(e)}" for k, e in p.exprs.items())
        line = f"{pad}Project[keep=({', '.join(p.keep or [])}) {exprs}]"
        return line + "\n" + format_logical_plan(p.child, indent + 1)
    if isinstance(p, LPredict):
        part = (
            f", partitioned over {p.partition_col} "
            f"({len(p.partitioned)} models)"
            if p.partitioned
            else ""
        )
        line = (
            f"{pad}Predict[{p.pipeline.n_ops()} ops, "
            f"{len(p.pipeline.inputs)} inputs -> "
            f"({', '.join(p.output_names)}); "
            f"runtime={p.transform or 'unassigned'}{part}]"
        )
        return line + "\n" + format_logical_plan(p.child, indent + 1)
    if isinstance(p, LAggregate):
        aggs = ", ".join(f"{n}={op}({c})" for n, op, c in p.aggs)
        line = f"{pad}Aggregate[{aggs}]"
        return line + "\n" + format_logical_plan(p.child, indent + 1)
    raise TypeError(type(p))


@dataclass
class PredictionQuery:
    """The unified IR instance for one prediction query."""

    plan: LogicalPlan
    stats: dict[str, TableStats] = field(default_factory=dict)

    def predict_nodes(self) -> list[LPredict]:
        return [n for n in walk(self.plan) if isinstance(n, LPredict)]

    def params(self) -> set[str]:
        """Names of the query's ``:param`` placeholders."""
        return plan_params(self.plan)

    def fingerprint(self) -> str:
        """Hash of (plan, stats): the optimizer's output is a pure function
        of both, so this keys the serving layer's optimized-plan cache."""
        return fingerprint(self.plan, self.stats)

    def copy(self) -> "PredictionQuery":
        import copy as _copy

        return PredictionQuery(plan=_deep_copy_plan(self.plan), stats=self.stats)


def _deep_copy_plan(p: LogicalPlan) -> LogicalPlan:
    if isinstance(p, LScan):
        return LScan(p.table, list(p.columns))
    if isinstance(p, LJoin):
        return LJoin(
            _deep_copy_plan(p.child), p.dim_table, p.fact_key, p.dim_key,
            list(p.dim_columns), p.fk_integrity,
        )
    if isinstance(p, LFilter):
        return LFilter(_deep_copy_plan(p.child), p.expr)
    if isinstance(p, LProject):
        return LProject(_deep_copy_plan(p.child), list(p.keep), dict(p.exprs))
    if isinstance(p, LPredict):
        return LPredict(
            _deep_copy_plan(p.child),
            p.pipeline.copy(),
            list(p.output_names),
            p.transform,
            [(k, pl.copy()) for k, pl in p.partitioned] if p.partitioned else None,
            p.partition_col,
            p.emit_prob,
        )
    if isinstance(p, LAggregate):
        return LAggregate(_deep_copy_plan(p.child), list(p.aggs))
    raise TypeError(type(p))
