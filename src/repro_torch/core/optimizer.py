"""The Raven optimizer: logical rules in strict order, then the runtime of
each predict node, then lowering to the physical plan.

Order (paper §5.2 closing summary):
  1. predicate-based model pruning   (enables more projection pushdown)
  2. data-induced optimizations      (same machinery, stats-sourced)
  3. model-projection pushdown       (consumes sparsity created by 1 & 2)
  4. the transform per predict node  (forced through the options, else
     the strategy's choice from the pipeline's statistics, else ``"none"``)
  5. lowering: LPredict → Project(exprs) | TensorOp | MLUdf

MLtoSQL / MLtoDNN failures fall back to the ML runtime ('none'), matching
the paper's whole-pipeline-or-fail semantics; MLtoDNN first tries to split
the pipeline around the ops it cannot lower. With a verify mode other than
``off`` the plan is checked after every rewrite and after lowering
(:mod:`repro_torch.analysis.verifier`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from torch import nn

from repro_torch.core.cost import CostModel
from repro_torch.core.fingerprint import fingerprint
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
from repro_torch.core.rules.data_induced import apply_data_induced
from repro_torch.core.rules.ml_to_dnn import (
    MLtoDNNUnsupported,
    compile_pipeline_to_dnn_partial,
)
from repro_torch.core.rules.ml_to_sql import (
    MLtoSQLUnsupported,
    compile_pipeline_to_sql,
)
from repro_torch.core.rules.predicate_pruning import apply_predicate_pruning
from repro_torch.core.rules.projection_pushdown import apply_projection_pushdown
from repro_torch.core.stats import pipeline_stats
from repro_torch.relational.engine import (
    Aggregate,
    Filter,
    Join,
    MLUdf,
    PhysicalPlan,
    Project,
    Scan,
    TensorOp,
    plan_children,
    walk_plan,
)
from repro_torch.ml.pipeline import _node_label as _pipeline_node_label
from repro_torch.relational.expr import (
    Bin,
    Case,
    Col,
    Const,
    Expr,
    Param,
    Un,
    columns_of,
    format_expr,
)

@dataclass
class OptimizerOptions:
    predicate_pruning: bool = True
    projection_pushdown: bool = True
    data_induced: bool = True
    # force {'none','sql','dnn'}; None -> the strategy's pick, else 'none'
    transform: Optional[str] = None
    tensor_strategy: str = "auto"  # 'auto' | 'gemm' | 'traversal'
    # the reference's use_pallas: None (or True) sends CUDA tensors to the
    # hand-written kernels, False runs the plain torch composition
    use_kernels: Optional[bool] = None
    udf_batch_size: int = 10_000
    # cost model judging pipeline cuts (split vs monolithic); None means a
    # fresh deterministic CostModel.default() per lowering, so plan-cache
    # fingerprints stay stable across processes
    cost_model: Optional[CostModel] = None
    # static plan verification: 'off' | 'warn' | 'strict' (True/False map
    # to strict/off); None defers to the RAVEN_VERIFY environment variable
    verify: Optional[str] = None


@dataclass
class OptimizationReport:
    transforms: dict[int, str] = field(default_factory=dict)
    notes: list[str] = field(default_factory=list)
    # stage-boundary annotation, filled at lowering time: one line per
    # physical stage ("pure: Scan[t]→Filter→TensorOp[...]" / "host: MLUdf")
    stages: list[str] = field(default_factory=list)
    # per-node runtime placement, one list per lowered predict node (in
    # lowering order): (pipeline-node label, runtime), where runtime is
    # "tensor" / "host" / "sql", suffixed with the split segment
    # ("tensor/prefix", "host/residual", "tensor/suffix") when the
    # pipeline-splitting MLtoDNN lowering cut the pipeline
    placement: list[list[tuple[str, str]]] = field(default_factory=list)
    # differential-verification trail (one line per checked rewrite phase),
    # filled when the verify mode is 'warn' or 'strict'; rendered by
    # explain()
    verification: list[str] = field(default_factory=list)
    # relational-op runtime placement (Join / Aggregate), filled after
    # lowering: (op label, runtime description). Reflects the process-wide
    # RAVEN_KERNELS mode captured when the stage graph is built.
    relational: list[tuple[str, str]] = field(default_factory=list)


class DNNOutputs(nn.Module):
    """An MLtoDNN TensorOp's program: the compiled pipeline (or one slice of
    a split pipeline) with its outputs renamed to plan columns; the 2-D
    outputs named in ``flat`` (the query-visible ones) are flattened, cut
    columns keep their (N, k) blocks."""

    def __init__(self, program: nn.Module, outputs: list[str], names: list[str],
                 flat):
        super().__init__()
        self.program = program
        self.outputs = list(outputs)
        self.names = list(names)
        self.flat = frozenset(flat)

    def forward(self, cols):
        res = self.program(cols)
        return {
            n: (res[o].reshape(-1) if n in self.flat and res[o].dim() > 1 else res[o])
            for o, n in zip(self.outputs, self.names)
        }


class RavenOptimizer:
    def __init__(self, strategy=None, options: Optional[OptimizerOptions] = None):
        self.strategy = strategy
        self.options = options or OptimizerOptions()

    # -- public API ---------------------------------------------------------

    def optimize(self, query: PredictionQuery) -> tuple[PhysicalPlan, OptimizationReport]:
        opt = self.options
        q = query.copy()
        report = OptimizationReport()

        # differential verification: re-check the plan after every rewrite
        # rule, so a violation names the rule that introduced it
        from repro_torch.analysis.verifier import (
            check_logical,
            enforce,
            resolve_verify_mode,
        )

        verify_mode = resolve_verify_mode(opt.verify)

        def checkpoint(phase: str) -> None:
            if verify_mode == "off":
                return
            report.verification += enforce(
                check_logical(q, where=phase), verify_mode, phase
            )

        checkpoint("input")
        if opt.predicate_pruning:
            apply_predicate_pruning(q)
            checkpoint("after predicate_pruning")
        if opt.data_induced:
            apply_data_induced(q)
            checkpoint("after data_induced")
        if opt.projection_pushdown:
            apply_projection_pushdown(q)
            checkpoint("after projection_pushdown")
        else:
            from repro_torch.core.rules.projection_pushdown import (
                prune_relational_columns,
            )

            # vanilla-engine behaviour: scans don't read columns no operator
            # references, but FK joins survive (join elimination is Raven's)
            prune_relational_columns(q, eliminate_joins=False)
            checkpoint("after column_pruning")

        # MLtoSQL runs here, before any threshold moves to logit space: a
        # pipeline it cannot translate falls back to the host MLUdf, which
        # emits probability-space scores, so its filters must stay as written
        sql: dict[int, tuple[dict[str, Expr], str]] = {}
        for i, pred in enumerate(q.predict_nodes()):
            if opt.transform is not None:
                t = opt.transform
            elif self.strategy is not None:
                t = self.strategy.choose(pipeline_stats(pred.pipeline))
            else:
                t = "none"
            pred.transform = t
            report.transforms[i] = t
            if t != "sql":
                continue
            try:
                sql[id(pred)] = self._sql_exprs(pred)
            except MLtoSQLUnsupported as e:
                report.notes.append(f"MLtoSQL fallback: {e}")
                pred.transform = "none"
                continue
            if sql[id(pred)][1] == "logit":
                score = pred.output_names[0]
                if _score_visible(q.plan, score):
                    # score reaches the query result (or a non-threshold
                    # expression): emit in probability space — exact
                    # semantics, one sigmoid at the top of the expression.
                    pred.emit_prob = True
                else:
                    # score only feeds threshold filters: keep the faster
                    # logit-space emission and move the thresholds instead.
                    rewrite_score_filters(q.plan, score, "logit")
        checkpoint("after transform_selection")

        plan = self._lower(q.plan, report, sql)
        from repro_torch.exec.stages import build_stage_graph, describe_segments
        from repro_torch.kernels.ops import kernels_enabled

        if verify_mode != "off":
            from repro_torch.analysis.verifier import check_graph

            report.verification += enforce(
                check_graph(build_stage_graph(plan)), verify_mode,
                "after lowering",
            )
        report.stages = describe_segments(plan)
        kern = kernels_enabled()
        for node in walk_plan(plan):
            if isinstance(node, Join):
                report.relational.append((
                    f"Join[{node.dim_table}] on "
                    f"{node.fact_key}={node.dim_key}",
                    "tensor/kernel: gather_join, upstream filter mask fused"
                    " (torch fallback when shapes don't qualify)"
                    if kern else
                    "tensor/torch: argsort+searchsorted gather",
                ))
            elif isinstance(node, Aggregate):
                aggs = ", ".join(f"{n}={op}({c})" for n, op, c in node.aggs)
                report.relational.append((
                    f"Aggregate[{aggs}]",
                    "tensor/kernel: segment_agg, filter folded in as mask"
                    if kern else
                    "tensor/torch: masked index_add_/scatter_reduce",
                ))
        n_host = sum(1 for s in report.stages if s.startswith("host"))
        if n_host:
            report.notes.append(
                f"lowered to {len(report.stages)} stages "
                f"({n_host} host boundary(ies) — bucketed per stage when served)"
            )
        return plan, report

    # -- lowering -----------------------------------------------------------

    def _lower(
        self, p: LogicalPlan, report: OptimizationReport,
        sql: dict[int, tuple[dict[str, Expr], str]],
    ) -> PhysicalPlan:
        if isinstance(p, LScan):
            return Scan(p.table, list(p.columns))
        if isinstance(p, LJoin):
            return Join(
                self._lower(p.child, report, sql), p.dim_table, p.fact_key,
                p.dim_key, list(p.dim_columns),
            )
        if isinstance(p, LFilter):
            return Filter(self._lower(p.child, report, sql), p.expr)
        if isinstance(p, LProject):
            return Project(self._lower(p.child, report, sql), list(p.keep), dict(p.exprs))
        if isinstance(p, LAggregate):
            return Aggregate(self._lower(p.child, report, sql), list(p.aggs))
        if isinstance(p, LPredict):
            opt = self.options
            child = self._lower(p.child, report, sql)
            t = p.transform or "none"
            if t == "sql":
                return self._lower_sql(p, child, *sql[id(p)], report)
            if t == "dnn":
                try:
                    # built on the host: CompiledPlan.run moves the programs
                    # to the run's device, where they pick their tree strategy
                    part = compile_pipeline_to_dnn_partial(
                        p.pipeline, strategy=opt.tensor_strategy,
                        use_kernels=opt.use_kernels,
                        rename=dict(zip(p.pipeline.outputs, p.output_names)),
                        cost_model=opt.cost_model, device="cpu",
                    )
                    return self._emit_dnn(p, child, part, report)
                except MLtoDNNUnsupported as e:
                    report.notes.append(f"MLtoDNN fallback: {e}")
                    t = "none"
            report.placement.append(
                [(_pipeline_node_label(n), "host") for n in p.pipeline.nodes]
            )
            return MLUdf(
                child, p.pipeline, list(p.output_names),
                batch_size=opt.udf_batch_size,
            )
        raise TypeError(type(p))

    def _emit_dnn(self, p: LPredict, child, part, report) -> PhysicalPlan:
        """Emit the physical plan for an MLtoDNN lowering — a single fused
        TensorOp when the whole pipeline is supported, else the split
        ``TensorOp(prefix) → MLUdf(residual) → TensorOp(suffix)`` chain with
        cut values threaded as reserved block columns (or one MLUdf where
        the cost model prices the split above the whole pipeline on the
        host)."""
        opt = self.options
        if part.full is not None:
            comp = part.full
            outs = list(p.pipeline.outputs)
            names = list(p.output_names)
            fn = DNNOutputs(comp.fn, outs, names, names)
            # canonical content token: the program's behaviour is a pure
            # function of (pipeline, outputs, strategy, kernels) — the
            # compiler's own token folds in its emission version — so two
            # lowerings of the same pipeline fingerprint identically, even
            # across processes
            fn.__fingerprint_token__ = fingerprint(
                "mltodnn", p.pipeline, outs, names,
                opt.tensor_strategy, opt.use_kernels,
                comp.fn.__fingerprint_token__,
            )
            # consumed-column schema for the StageGraph
            fn.__input_names__ = tuple(comp.input_names)
            if comp.fused:
                report.notes.append(
                    "MLtoDNN fused featurize kernel: " + ", ".join(comp.fused)
                )
            report.placement.append(
                [(label, "tensor") for label, _ in part.split.placement]
            )
            return TensorOp(child, fn, names)

        if part.decision is not None and part.decision.choice == "monolithic":
            # the cost model priced the split's boundary crossings above the
            # tensor speedup: emit one host MLUdf over the whole pipeline
            report.placement.append(
                [(label, "host") for label, _ in part.split.placement]
            )
            report.notes.append(part.decision.note())
            return MLUdf(
                child, p.pipeline, list(p.output_names),
                batch_size=opt.udf_batch_size,
            )

        runtime = {
            "prefix": "tensor/prefix",
            "residual": "host/residual",
            "suffix": "tensor/suffix",
        }
        report.placement.append(
            [(label, runtime[seg]) for label, seg in part.split.placement]
        )
        final = set(p.output_names)

        def tensor_op(plan, comp, seg, tag) -> TensorOp:
            fn = DNNOutputs(comp.fn, seg.pipeline.outputs, seg.out_cols,
                            final & set(seg.out_cols))
            fn.__fingerprint_token__ = fingerprint(
                "mltodnn_split", tag, seg.pipeline, seg.out_cols,
                seg.consumes, opt.tensor_strategy, opt.use_kernels,
                comp.fn.__fingerprint_token__,
            )
            fn.__input_names__ = tuple(comp.input_names)
            return TensorOp(plan, fn, list(seg.out_cols),
                            consumes=tuple(seg.consumes))

        plan: PhysicalPlan = child
        fused: list[str] = []
        if part.prefix is not None:
            comp, seg = part.prefix
            fused += list(comp.fused)
            plan = tensor_op(plan, comp, seg, "prefix")
        seg = part.residual
        plan = MLUdf(
            plan, seg.pipeline, list(seg.out_cols),
            batch_size=opt.udf_batch_size, consumes=tuple(seg.consumes),
        )
        if part.suffix is not None:
            comp, seg = part.suffix
            fused += list(comp.fused)
            plan = tensor_op(plan, comp, seg, "suffix")
        n_res = sum(1 for _, s in part.split.placement if s == "residual")
        n_all = len(part.split.placement)
        report.notes.append(
            f"MLtoDNN split: {n_all - n_res}/{n_all} pipeline ops lowered to "
            f"the tensor runtime; {n_res}-op residual stays on host"
        )
        if part.decision is not None:
            report.notes.append(part.decision.note())
        if fused:
            report.notes.append(
                "MLtoDNN fused featurize kernel: " + ", ".join(fused)
            )
        return plan

    @staticmethod
    def _sql_exprs(p: LPredict) -> tuple[dict[str, Expr], str]:
        """MLtoSQL compilation of a predict node, incl. per-partition
        specialized expressions: (output column -> expression, score
        space). Raises :exc:`MLtoSQLUnsupported`."""
        if p.partitioned and p.partition_col:
            comps = [
                (key, compile_pipeline_to_sql(pl)) for key, pl in p.partitioned
            ]
            exprs: dict[str, Expr] = {}
            for out, name in zip(p.pipeline.outputs, p.output_names):
                expr: Expr = comps[-1][1].exprs[out]
                for key, comp in comps[:-1]:
                    expr = Case(
                        Bin("eq", Col(p.partition_col), Const(float(key))),
                        comp.exprs[out],
                        expr,
                    )
                exprs[name] = expr
            return exprs, comps[0][1].score_space
        comp = compile_pipeline_to_sql(p.pipeline)
        exprs = {
            name: comp.exprs[out]
            for out, name in zip(p.pipeline.outputs, p.output_names)
        }
        return exprs, comp.score_space

    def _lower_sql(
        self, p: LPredict, child: PhysicalPlan, exprs: dict[str, Expr],
        space: str, report,
    ) -> PhysicalPlan:
        """MLtoSQL lowering: the compiled expressions as one Project."""
        if p.partitioned and p.partition_col:
            report.notes.append(
                f"MLtoSQL partitioned over {p.partition_col} "
                f"({len(p.partitioned)} specialized models)"
            )
        if space == "logit":
            if p.emit_prob:
                score_name = p.output_names[0]
                exprs[score_name] = Un("sigmoid", exprs[score_name])
                report.notes.append(
                    f"score column '{score_name}' emitted in probability "
                    "space (sigmoid applied — score is query-visible)"
                )
            else:
                report.notes.append(
                    f"score column '{p.output_names[0]}' emitted in logit "
                    "space (threshold filters rewritten)"
                )
        report.placement.append(
            [(_pipeline_node_label(n), "sql") for n in p.pipeline.nodes]
        )
        return Project(child, None, exprs)


def _logical_out_cols(p: LogicalPlan) -> list[str]:
    """Output-column inference for logical plans."""
    if isinstance(p, LScan):
        return list(p.columns)
    if isinstance(p, LJoin):
        return _logical_out_cols(p.child) + list(p.dim_columns)
    if isinstance(p, LFilter):
        return _logical_out_cols(p.child)
    if isinstance(p, LProject):
        base = list(p.keep) if p.keep is not None else _logical_out_cols(p.child)
        return base + list(p.exprs)
    if isinstance(p, LPredict):
        return _logical_out_cols(p.child) + list(p.output_names)
    if isinstance(p, LAggregate):
        return [a[0] for a in p.aggs]
    raise TypeError(type(p))


def _is_threshold_filter(e: Expr, score_col: str) -> bool:
    """True iff every reference to ``score_col`` in ``e`` is a rewritable
    ``score <op> const`` comparison (possibly under and/or)."""
    if isinstance(e, Bin) and e.op in ("and", "or"):
        return _is_threshold_filter(e.a, score_col) and _is_threshold_filter(
            e.b, score_col
        )
    if (
        isinstance(e, Bin)
        and e.op in ("ge", "gt", "le", "lt")
        and isinstance(e.a, Col)
        and e.a.name == score_col
        and isinstance(e.b, (Const, Param))
    ):
        return True
    return score_col not in columns_of(e)


def _score_visible(plan: LogicalPlan, score_col: str) -> bool:
    """Does the score column escape threshold filters — i.e. reach the query
    result, an aggregate, or a projection expression? If so, MLtoSQL must
    emit it in probability space."""
    from repro_torch.core.ir import walk

    if score_col in _logical_out_cols(plan):
        return True
    for node in walk(plan):
        if isinstance(node, LAggregate):
            if any(col == score_col for _, _, col in node.aggs):
                return True
        elif isinstance(node, LProject):
            if any(score_col in columns_of(e) for e in node.exprs.values()):
                return True
        elif isinstance(node, LFilter):
            if not _is_threshold_filter(node.expr, score_col):
                return True
    return False


def rewrite_score_filters(
    plan: LogicalPlan, score_col: str, to_space: str
) -> None:
    """Rewrite prob-space score predicates to logit space in-place
    (needed when MLtoSQL emits logit-space scores)."""
    from repro_torch.core.ir import walk

    if to_space != "logit":
        return
    for node in walk(plan):
        if isinstance(node, LFilter):
            node.expr = _rewrite_expr(node.expr, score_col)


def _rewrite_expr(e: Expr, score_col: str) -> Expr:
    if (
        isinstance(e, Bin)
        and e.op in ("ge", "gt", "le", "lt")
        and isinstance(e.a, Col)
        and e.a.name == score_col
    ):
        if isinstance(e.b, Const):
            p = min(max(float(e.b.value), 1e-9), 1 - 1e-9)
            return Bin(e.op, e.a, Const(float(math.log(p / (1 - p)))))
        if isinstance(e.b, Param):
            # bound value arrives at run time: defer the prob->logit map
            # into the compiled program (same clipping as the static path)
            return Bin(e.op, e.a, Un("logit", e.b))
    if isinstance(e, Bin) and e.op in ("and", "or"):
        return Bin(e.op, _rewrite_expr(e.a, score_col), _rewrite_expr(e.b, score_col))
    return e


def format_physical_plan(p: PhysicalPlan, indent: int = 0) -> str:
    """Indented rendering of a lowered physical plan (EXPLAIN output).

    Scans show the columns that survived projection pushdown; Projects show
    compiled model expressions (summarized when large); Filters show the
    thresholds as bound (``:param`` placeholders by name).
    """
    pad = "  " * indent
    if isinstance(p, Scan):
        line = f"{pad}Scan[{p.table}] cols=({', '.join(p.columns)})"
    elif isinstance(p, Join):
        line = (
            f"{pad}Join[{p.dim_table}] on {p.fact_key}={p.dim_key} "
            f"bring=({', '.join(p.dim_columns)})"
        )
    elif isinstance(p, Filter):
        line = f"{pad}Filter[{format_expr(p.expr)}]"
    elif isinstance(p, Project):
        exprs = ", ".join(f"{k}={format_expr(e)}" for k, e in p.exprs.items())
        keep = "*" if p.keep is None else f"({', '.join(p.keep)})"
        line = f"{pad}Project[keep={keep}{'; ' + exprs if exprs else ''}]"
    elif isinstance(p, MLUdf):
        line = (
            f"{pad}MLUdf[{p.pipeline.n_ops()}-op pipeline -> "
            f"({', '.join(p.output_names)}); host boundary, "
            f"batch={p.batch_size}]"
        )
    elif isinstance(p, TensorOp):
        line = f"{pad}TensorOp[fused tensor program -> ({', '.join(p.output_names)})]"
    elif isinstance(p, Aggregate):
        aggs = ", ".join(f"{n}={op}({c})" for n, op, c in p.aggs)
        line = f"{pad}Aggregate[{aggs}]"
    else:
        raise TypeError(type(p))
    kids = plan_children(p)
    return "\n".join([line] + [format_physical_plan(c, indent + 1) for c in kids])
