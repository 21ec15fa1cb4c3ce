"""Per-op cost model driving pipeline cut selection.

``split_pipeline`` (ml/pipeline.py) is the candidate *generator*: it computes
the structural prefix/residual/suffix cut — maximal tensor coverage with the
minimal host residual. This module is the *judge*: given that structural cut,
it prices the two plan shapes the verifier's ``residual-minimal`` rule
admits —

  * **split** — ``TensorOp(prefix) → MLUdf(residual) → TensorOp(suffix)``:
    supported ops run at tensor rates, but every value crossing a cut
    becomes a ``__pv_*`` block column materialized across the host boundary,
    and each tensor segment adds dispatch overhead;
  * **monolithic** — one host MLUdf over the whole pipeline: every op at
    host rates, but nothing extra crosses the boundary.

(Any *other* cut — demoting supported ops into the residual — is rejected by
``residual-minimal``, so {structural split, monolithic} is the complete
rule-compatible candidate set; both shapes carry exactly one host boundary,
so cost-based selection can never add one.)

Rates start from hand-seeded defaults and are *calibrated* from the per-stage
dispatch timings the serving layer already collects and ``explain()``
renders (``Stage.calls`` / ``Stage.total_s``): observing a served StageGraph
rescales the per-op ns/row rates so predicted stage time matches measured
stage time. A calibrated model is passed through
``OptimizerOptions.cost_model`` — it is a plain dataclass of floats, so plan
cache keys fold its rates in content-stably.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


# hand-seeded ns/row rates per pipeline-op kind (CPU-interpreter host path
# vs fused tensor path); unknown kinds fall back to the defaults below
_HOST_NS = {
    "scaler": 220.0,
    "one_hot": 420.0,
    "concat": 260.0,
    "linear": 320.0,
    "tree_ensemble": 2400.0,
    "python_udf": 3200.0,
}
_TENSOR_NS = {
    "scaler": 8.0,
    "one_hot": 30.0,
    "concat": 12.0,
    "linear": 35.0,
    "tree_ensemble": 260.0,
}


@dataclass
class CutDecision:
    """Outcome of pricing one pipeline's candidate cuts."""

    choice: str  # "split" | "monolithic"
    split_s: float
    monolithic_s: float
    rows: int

    def note(self) -> str:
        pick = (
            "kept the structural split"
            if self.choice == "split"
            else "collapsed the split to one monolithic host UDF"
        )
        return (
            f"cost-based cut: {pick} "
            f"(est split {1e3 * self.split_s:.2f}ms vs monolithic "
            f"{1e3 * self.monolithic_s:.2f}ms @ {self.rows} rows)"
        )


@dataclass
class CostModel:
    """Per-op-kind per-row rates plus boundary-crossing costs.

    All fields are plain floats/dicts so the model fingerprints content-
    stably into plan-cache keys. ``rows_hint`` is the batch size decisions
    are priced at (per-row rates make the *relative* ranking insensitive to
    it; it matters only against the fixed per-dispatch overheads).
    """

    host_ns: dict[str, float] = field(default_factory=lambda: dict(_HOST_NS))
    tensor_ns: dict[str, float] = field(
        default_factory=lambda: dict(_TENSOR_NS)
    )
    default_host_ns: float = 800.0
    default_tensor_ns: float = 60.0
    # block-column materialization across the host boundary (per crossing
    # column per row: device→host sync + numpy round-trip)
    crossing_ns_per_row: float = 45.0
    # fixed dispatch overhead per extra tensor segment the split introduces
    segment_fixed_us: float = 250.0
    rows_hint: int = 4096
    # EWMA blend for calibration updates
    alpha: float = 0.5

    @classmethod
    def default(cls) -> "CostModel":
        return cls()

    # -- pricing -------------------------------------------------------------

    def op_s(self, kind: str, runtime: str, rows: int) -> float:
        if runtime == "host":
            ns = self.host_ns.get(kind, self.default_host_ns)
        else:
            ns = self.tensor_ns.get(kind, self.default_tensor_ns)
        return ns * rows * 1e-9

    def pipeline_s(self, nodes, runtime: str, rows: int) -> float:
        return sum(self.op_s(n.op, runtime, rows) for n in nodes)

    def choose_cut(self, split, nodes, rows: Optional[int] = None) -> CutDecision:
        """Price the structural ``split`` (a PipelineSplit) of ``nodes``
        against the monolithic host lowering and pick the cheaper."""
        rows = int(rows or self.rows_hint)
        mono = self.pipeline_s(nodes, "host", rows)
        split_s = 0.0
        for n, (_, seg) in zip(nodes, split.placement):
            runtime = "host" if seg == "residual" else "tensor"
            split_s += self.op_s(n.op, runtime, rows)
        n_cross = 0
        n_segments = 0
        for part in (split.prefix, split.suffix):
            if part is not None:
                n_segments += 1
                n_cross += sum(
                    1 for c in part.out_cols if c.startswith("__pv_")
                )
        split_s += n_cross * self.crossing_ns_per_row * rows * 1e-9
        split_s += n_segments * self.segment_fixed_us * 1e-6
        choice = "split" if split_s <= mono else "monolithic"
        return CutDecision(
            choice=choice, split_s=split_s, monolithic_s=mono, rows=rows
        )

    # -- calibration ---------------------------------------------------------

    def observe(self, kinds, runtime: str, rows: int, seconds: float) -> None:
        """Blend measured wall time for one executed op slice into the
        per-kind rates: every involved kind is rescaled toward making the
        predicted slice time match the measurement."""
        if rows <= 0 or seconds <= 0 or not kinds:
            return
        rates = self.host_ns if runtime == "host" else self.tensor_ns
        default = (
            self.default_host_ns if runtime == "host" else self.default_tensor_ns
        )
        predicted = sum(rates.get(k, default) for k in kinds) * rows * 1e-9
        if predicted <= 0:
            return
        factor = seconds / predicted
        for k in set(kinds):
            cur = rates.get(k, default)
            rates[k] = (1.0 - self.alpha) * cur + self.alpha * cur * factor

    def calibrate_from_graph(self, graph, rows: int) -> int:
        """Calibrate from a served StageGraph's dispatch timings — the same
        ``calls``/``total_s`` accounting ``explain()`` renders per stage.
        Host (MLUdf) stages attribute their measured per-call time to their
        pipeline ops at host rates; pure stages containing a TensorOp
        attribute theirs at tensor rates. Returns the number of stages
        observed."""
        n = 0
        for stage in graph.stages:
            if not stage.calls or stage.total_s <= 0:
                continue
            per_call = stage.total_s / stage.calls
            if stage.kind == "host" and stage.udf is not None:
                kinds = [nd.op for nd in stage.udf.pipeline.nodes]
                self.observe(kinds, "host", rows, per_call)
                n += 1
            elif stage.kind == "pure":
                kinds = []
                for op in stage.ops:
                    pipe = getattr(op, "pipeline", None)
                    if pipe is not None:
                        kinds += [nd.op for nd in pipe.nodes]
                if kinds:
                    self.observe(kinds, "tensor", rows, per_call)
                    n += 1
        return n
