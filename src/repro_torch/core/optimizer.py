"""The Raven optimizer: logical rules in strict order, then lowering to the
physical plan.

Order (paper §5.2 closing summary):
  1. predicate-based model pruning   (enables more projection pushdown)
  2. data-induced optimizations      (same machinery, stats-sourced)
  3. model-projection pushdown       (consumes sparsity created by 1 & 2)
  4. the transform per predict node  (forced through the options)
  5. lowering: LPredict → TensorOp

This slice of the port lowers ``transform="dnn"`` only, whole pipelines
only. MLtoSQL (``"sql"``), the interpreted ML runtime (``"none"``), the
learned runtime selection (``transform=None``) and split lowering raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from torch import nn

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
    compile_pipeline_to_dnn,
)
from repro_torch.core.rules.predicate_pruning import apply_predicate_pruning
from repro_torch.core.rules.projection_pushdown import apply_projection_pushdown
from repro_torch.relational.engine import (
    Aggregate,
    Filter,
    Join,
    PhysicalPlan,
    Project,
    Scan,
    TensorOp,
    walk_plan,
)

_NOT_PORTED = {
    "sql": "MLtoSQL (ROADMAP.md Queue 1, MLtoSQL)",
    "none": "the interpreted ML runtime behind an MLUdf host boundary "
            "(ROADMAP.md Queue 1, split lowering)",
    None: "learned runtime selection (ROADMAP.md Queue 1, runtime "
          "selection: core/strategies.py)",
}


@dataclass
class OptimizerOptions:
    predicate_pruning: bool = True
    projection_pushdown: bool = True
    data_induced: bool = True
    transform: Optional[str] = None  # force {'none','sql','dnn'}; None -> strategy
    tensor_strategy: str = "auto"  # 'auto' | 'gemm' | 'traversal'
    # the reference's use_pallas: None (or True) sends CUDA tensors to the
    # hand-written kernels, False runs the plain torch composition
    use_kernels: Optional[bool] = None


@dataclass
class OptimizationReport:
    transforms: dict[int, str] = field(default_factory=dict)
    notes: list[str] = field(default_factory=list)
    # stage-boundary annotation, filled at lowering time: one line per
    # physical stage ("pure: Scan[t]→Filter→TensorOp[...]")
    stages: list[str] = field(default_factory=list)
    # relational-op runtime placement (Join / Aggregate), filled after
    # lowering: (op label, runtime description). Reflects the process-wide
    # RAVEN_KERNELS mode captured when the stage graph is built.
    relational: list[tuple[str, str]] = field(default_factory=list)


class DNNOutputs(nn.Module):
    """An MLtoDNN TensorOp's program: the compiled pipeline with its graph
    outputs renamed to plan columns (2-D outputs flattened)."""

    def __init__(self, program: nn.Module, outputs: list[str], names: list[str]):
        super().__init__()
        self.program = program
        self.outputs = list(outputs)
        self.names = list(names)

    def forward(self, cols):
        res = self.program(cols)
        return {
            n: (res[o].reshape(-1) if res[o].dim() > 1 else res[o])
            for o, n in zip(self.outputs, self.names)
        }


class RavenOptimizer:
    def __init__(self, strategy=None, options: Optional[OptimizerOptions] = None):
        if strategy is not None:
            raise NotImplementedError(
                f"a runtime-selection strategy is not ported yet: {_NOT_PORTED[None]}"
            )
        self.options = options or OptimizerOptions()

    # -- public API ---------------------------------------------------------

    def optimize(self, query: PredictionQuery) -> tuple[PhysicalPlan, OptimizationReport]:
        opt = self.options
        q = query.copy()
        report = OptimizationReport()

        if opt.predicate_pruning:
            apply_predicate_pruning(q)
        if opt.data_induced:
            apply_data_induced(q)
        if opt.projection_pushdown:
            apply_projection_pushdown(q)
        else:
            from repro_torch.core.rules.projection_pushdown import (
                prune_relational_columns,
            )

            # vanilla-engine behaviour: scans don't read columns no operator
            # references, but FK joins survive (join elimination is Raven's)
            prune_relational_columns(q, eliminate_joins=False)

        for i, pred in enumerate(q.predict_nodes()):
            t = opt.transform
            if t != "dnn":
                raise NotImplementedError(
                    f"transform={t!r} is not ported yet: {_NOT_PORTED.get(t, t)}"
                    "; use transform='dnn'"
                )
            pred.transform = t
            report.transforms[i] = t

        plan = self._lower(q.plan, report)
        from repro_torch.exec.stages import describe_segments
        from repro_torch.kernels.ops import kernels_enabled

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
        return plan, report

    # -- lowering -----------------------------------------------------------

    def _lower(self, p: LogicalPlan, report: OptimizationReport) -> PhysicalPlan:
        if isinstance(p, LScan):
            return Scan(p.table, list(p.columns))
        if isinstance(p, LJoin):
            return Join(
                self._lower(p.child, report), p.dim_table, p.fact_key,
                p.dim_key, list(p.dim_columns),
            )
        if isinstance(p, LFilter):
            return Filter(self._lower(p.child, report), p.expr)
        if isinstance(p, LProject):
            return Project(self._lower(p.child, report), list(p.keep), dict(p.exprs))
        if isinstance(p, LAggregate):
            return Aggregate(self._lower(p.child, report), list(p.aggs))
        if isinstance(p, LPredict):
            child = self._lower(p.child, report)
            opt = self.options
            try:
                # built on the host: CompiledPlan.run moves the program to
                # the run's device, where it picks its tree strategy
                comp = compile_pipeline_to_dnn(
                    p.pipeline, strategy=opt.tensor_strategy,
                    use_kernels=opt.use_kernels, device="cpu",
                )
            except MLtoDNNUnsupported as e:
                raise NotImplementedError(
                    f"pipeline needs split lowering ({e}), which is not "
                    "ported yet: ROADMAP.md Queue 1, split lowering"
                ) from e
            return self._emit_dnn(p, child, comp, report)
        raise TypeError(type(p))

    def _emit_dnn(self, p: LPredict, child, comp, report) -> PhysicalPlan:
        """Emit the single fused TensorOp of a whole-pipeline lowering."""
        opt = self.options
        outs = list(p.pipeline.outputs)
        names = list(p.output_names)
        fn = DNNOutputs(comp.fn, outs, names)
        # canonical content token: the program's behaviour is a pure
        # function of (pipeline, outputs, strategy, kernels) — the compiler's
        # own token folds in its emission version — so two lowerings of the
        # same pipeline fingerprint identically, even across processes
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
        return TensorOp(child, fn, names)
