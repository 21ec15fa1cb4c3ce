"""StageGraph: the physical stage IR of the execution layer (pure stages).

Lowering a physical plan produces a graph of :class:`Stage` nodes, each
carrying:

  * its operator slice of the plan (a maximal pure segment),
  * its output columns,
  * a canonical per-stage content fingerprint (chained through upstream
    stages, so a stage's hash identifies *this stage of this plan*),
  * runtime accounting (calls, wall time).

Execution threads a three-part state ``(columns, valid, seg)`` through the
stages: ``valid`` is the row-validity mask that makes padded serving exact,
and ``seg`` is an optional per-row request-segment id that lets aggregates
fold per request instead of per batch.

This slice of the port runs pure stages only: a plan holding an ``MLUdf``
host boundary (split lowering, or no lowering at all) raises
``NotImplementedError``. PyTorch runs eagerly, so a stage is its composed
``env -> state`` function, called directly; there is no tracing to count.
The stage schema the reference's verifier and serving layer read (tables
and columns read, ``:param`` slots) comes with those modules.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.relational.expr import eval_expr
from repro_torch.relational.table import Table

# -- execution-environment keys ---------------------------------------------

# initial fact-spine validity mask (padded serving)
ROW_VALID_KEY = "__row_valid__"
# bound :param values (0-d tensors): runtime inputs
PARAMS_KEY = "__params__"
# per-row request-segment ids (int32), present only under coalesced serving
ROW_SEG_KEY = "__row_seg__"
# baked dim-table sort data, injected once per execution by the engine:
# {dim_table: {"keys": sorted_keys, "order": argsort_perm[, "unique": ...]}}.
# Dim tables are frozen at registration, so the engine computes (and caches)
# the sorted order on the host instead of re-sorting on the device on every
# call; the Join step sorts in-stage only when the entry is absent.
DIMSORT_KEY = "__dimsort__"
# arange(num_segment_slots): its length tells segmented aggregates their
# output width (slot count is power-of-two bucketed)
SEG_SLOTS_KEY = "__seg_slots__"
# runtime scalar: how many of the segment slots are real requests
SEG_COUNT_KEY = "__seg_count__"

# state threaded through stages: (columns, valid-mask, segment-ids-or-None)
State = tuple[dict[str, torch.Tensor], torch.Tensor, Optional[torch.Tensor]]

# where the unported host-boundary execution is queued
HOST_BOUNDARY_ITEM = (
    "ROADMAP.md Queue 1 (split lowering: MLUdf / run_udf / host_step)"
)


def seg_bucket(k: int, min_bucket: int = 4) -> int:
    """Power-of-two segment-slot bucket for ``k`` coalesced requests."""
    b = max(int(min_bucket), 1)
    while b < k:
        b <<= 1
    return b


# ---------------------------------------------------------------------------
# Pure-operator steps (env -> State composition)
# ---------------------------------------------------------------------------


def pure_step(plan, inner: Optional[Callable[[dict], State]]) -> Callable[[dict], State]:
    """Compose one pure operator on top of ``inner`` (env -> state)."""
    from repro_torch.relational.engine import (
        Aggregate,
        Filter,
        Join,
        Project,
        Scan,
        TensorOp,
    )

    if isinstance(plan, Scan):
        def fn(env, _plan=plan):
            cols = {c: env[_plan.table][c] for c in _plan.columns}
            first = next(iter(cols.values()))
            # the serving layer pads batches to a shape bucket and marks the
            # pad rows invalid up front via ROW_VALID_KEY
            rv = env.get(ROW_VALID_KEY)
            valid = (
                torch.ones((first.shape[0],), dtype=torch.bool, device=first.device)
                if rv is None else rv.to(torch.bool)
            )
            return cols, valid, env.get(ROW_SEG_KEY)
        return fn

    if isinstance(plan, Join):
        # relational-kernel mode is a codegen decision: captured once at
        # stage-build time, and folded into the stage fingerprint by
        # build_stage_graph so the two modes never alias
        from repro_torch.kernels.ops import kernels_enabled

        use_kernels = kernels_enabled()

        def fn(env, _plan=plan, _kern=use_kernels):
            from repro_torch.tensor.compile import (
                emit_join_kernel,
                join_kernel_qualifies,
            )

            cols, valid, seg = inner(env)
            dim = env[_plan.dim_table]
            keys = dim[_plan.dim_key]
            fk = cols[_plan.fact_key]
            ds = env.get(DIMSORT_KEY, {}).get(_plan.dim_table)
            if _kern and join_kernel_qualifies(_plan, dim, fk, ds):
                brought, hit = emit_join_kernel(_plan, dim, fk, ds)
                out = dict(cols)
                out.update(brought)
                return out, valid & hit, seg
            if ds is not None:  # baked at registration
                order = ds["order"].to(torch.int64)
                skeys = ds["keys"]
            else:
                order = torch.argsort(keys, stable=True)
                skeys = keys[order]
            pos = torch.searchsorted(skeys, fk.to(skeys.dtype))
            pos = torch.clamp(pos, 0, skeys.shape[0] - 1)
            hit = skeys[pos] == fk
            gather = order[pos]
            out = dict(cols)
            for c in _plan.dim_columns:
                out[c] = dim[c][gather]
            return out, valid & hit, seg
        return fn

    if isinstance(plan, Filter):
        def fn(env, _plan=plan):
            cols, valid, seg = inner(env)
            keep = eval_expr(_plan.expr, cols, env.get(PARAMS_KEY))
            return cols, valid & keep.to(torch.bool), seg
        return fn

    if isinstance(plan, Project):
        def fn(env, _plan=plan):
            cols, valid, seg = inner(env)
            keep = _plan.keep if _plan.keep is not None else list(cols)
            out = {c: cols[c] for c in keep}
            for name, e in _plan.exprs.items():
                out[name] = eval_expr(e, cols, env.get(PARAMS_KEY))
            return out, valid, seg
        return fn

    if isinstance(plan, TensorOp):
        def fn(env, _plan=plan):
            cols, valid, seg = inner(env)
            out = dict(cols)
            out.update(_plan.fn(cols))
            for c in _plan.consumes:  # block columns ending here (split)
                out.pop(c, None)
            return out, valid, seg
        return fn

    if isinstance(plan, Aggregate):
        from repro_torch.kernels.ops import kernels_enabled

        use_kernels = kernels_enabled()

        def fn(env, _plan=plan, _kern=use_kernels):
            from repro_torch.tensor.compile import emit_aggregate_kernel

            cols, valid, seg = inner(env)
            w = valid.to(torch.float32)
            one = torch.ones((1,), dtype=torch.bool, device=valid.device)
            if seg is None:
                # global fold: a single output row; the upstream filter is
                # already folded in as the validity weight
                sid0 = torch.zeros_like(valid, dtype=torch.int32)
                if _kern:
                    out = emit_aggregate_kernel(_plan.aggs, cols, w, sid0, 1)
                    return out, one, None
                out = {}
                nvalid = torch.sum(w)
                for name, op, col in _plan.aggs:
                    if op == "count":
                        out[name] = nvalid[None]
                    elif op == "sum":
                        out[name] = torch.sum(cols[col] * w)[None]
                    elif op == "mean":
                        out[name] = (
                            torch.sum(cols[col] * w) / torch.clamp(nvalid, min=1.0)
                        )[None]
                    elif op in ("min", "max"):
                        out[name] = _masked_extremum(
                            op, cols[col], valid, nvalid[None], sid0, 1
                        )
                    else:
                        raise ValueError(op)
                return out, one, None
            # segmented fold: one output row per request slot. Invalid/pad
            # rows carry weight 0, so routing them to slot 0 is harmless
            slots = env[SEG_SLOTS_KEY]
            ns = slots.shape[0]
            k = env[SEG_COUNT_KEY]
            sid = torch.where(valid, seg, torch.zeros_like(seg))
            if _kern:
                out = emit_aggregate_kernel(_plan.aggs, cols, w, sid, ns)
                return out, slots < k, slots
            idx = sid.to(torch.int64)
            counts = w.new_zeros((ns,)).index_add_(0, idx, w)
            out = {}
            for name, op, col in _plan.aggs:
                if op == "count":
                    out[name] = counts
                elif op == "sum":
                    out[name] = w.new_zeros((ns,)).index_add_(0, idx, cols[col] * w)
                elif op == "mean":
                    s = w.new_zeros((ns,)).index_add_(0, idx, cols[col] * w)
                    out[name] = s / torch.clamp(counts, min=1.0)
                elif op in ("min", "max"):
                    out[name] = _masked_extremum(
                        op, cols[col], valid, counts, sid, ns
                    )
                else:
                    raise ValueError(op)
            return out, slots < k, slots
        return fn

    raise TypeError(type(plan))


def _masked_extremum(op, values, valid, counts, sid, ns):
    """Segment min/max over valid rows only; empty segments yield 0.0 (the
    same convention in the legacy composition, the plain version and the
    kernel, so every dispatch path agrees)."""
    v = values.to(torch.float32)
    inf = float("inf")
    idx = sid.to(torch.int64)
    if op == "min":
        m = v.new_full((ns,), inf).scatter_reduce_(
            0, idx, torch.where(valid, v, inf), reduce="amin"
        )
    else:
        m = v.new_full((ns,), -inf).scatter_reduce_(
            0, idx, torch.where(valid, v, -inf), reduce="amax"
        )
    return torch.where(counts > 0, m, m.new_zeros(()))


# ---------------------------------------------------------------------------
# Stage / StageGraph
# ---------------------------------------------------------------------------


@dataclass
class Stage:
    """One node of the stage graph: a maximal pure operator segment.
    ``fingerprint`` is a canonical content hash of this stage's operators
    chained through every upstream stage's hash."""

    index: int
    kind: str  # "pure"
    ops: list  # plan-node slice, innermost first
    fingerprint: str
    out_columns: tuple[str, ...]
    fn: Optional[Callable[[dict], State]] = None  # raw env -> state
    calls: int = 0
    total_s: float = 0.0

    @property
    def label(self) -> str:
        """Compact operator chain, e.g. ``Scan[patients]→Filter``."""
        return "→".join(_op_label(op) for op in self.ops)


@dataclass
class StageGraph:
    """The lowered physical plan: a linear chain of stages."""

    plan: Any  # the PhysicalPlan this graph was lowered from
    stages: list[Stage]


# ---------------------------------------------------------------------------
# Plan segmentation + schema inference
# ---------------------------------------------------------------------------


def _linearize(plan) -> list:
    """Plan nodes innermost (Scan) first. Plans are linear chains."""
    from repro_torch.relational.engine import walk_plan

    return list(walk_plan(plan))[::-1]


def plan_segments(plan) -> list[tuple[str, list]]:
    """Split a plan into maximal pure segments and host-boundary segments
    (``[(kind, ops), ...]``, ops innermost-first)."""
    from repro_torch.relational.engine import MLUdf

    segments: list[tuple[str, list]] = []
    for op in _linearize(plan):
        if isinstance(op, MLUdf):
            segments.append(("host", [op]))
        elif segments and segments[-1][0] == "pure":
            segments[-1][1].append(op)
        else:
            segments.append(("pure", [op]))
    return segments


def _op_label(op) -> str:
    """One operator's display label."""
    name = type(op).__name__
    if name == "Scan":
        return f"Scan[{op.table}]"
    if name == "Join":
        return f"Join[{op.dim_table}]"
    if name == "TensorOp":
        ins = getattr(op.fn, "__input_names__", None)
        arity = f"{len(ins)}→{len(op.output_names)}" if ins is not None else (
            f"→{len(op.output_names)}"
        )
        return f"TensorOp[{arity}]"
    return name


def describe_segments(plan) -> list[str]:
    """Human-readable stage-boundary annotation (one line per stage), used by
    the optimizer's report at lowering time."""
    return [
        f"{kind}: " + "→".join(_op_label(op) for op in ops)
        for kind, ops in plan_segments(plan)
    ]


def _segment_out_cols(ops, in_cols: Optional[list[str]]) -> list[str]:
    """Fold output-column inference over one segment's operator slice."""
    from repro_torch.relational.engine import (
        Aggregate,
        Filter,
        Join,
        Project,
        Scan,
        TensorOp,
    )

    cur = list(in_cols or [])
    for op in ops:
        if isinstance(op, Scan):
            cur = list(op.columns)
        elif isinstance(op, Join):
            cur = cur + list(op.dim_columns)
        elif isinstance(op, Filter):
            pass
        elif isinstance(op, Project):
            base = list(op.keep) if op.keep is not None else cur
            cur = base + [c for c in op.exprs if c not in base]
        elif isinstance(op, TensorOp):
            cur = [c for c in cur if c not in op.consumes]
            cur = cur + [c for c in op.output_names if c not in cur]
        elif isinstance(op, Aggregate):
            cur = [a[0] for a in op.aggs]
        else:
            raise TypeError(type(op))
    return cur


def build_stage_graph(plan, pins: Optional[list] = None) -> StageGraph:
    """Lower a physical plan into its :class:`StageGraph`.

    Each pure segment gets an ``env -> state`` callable composed from
    :func:`pure_step`. Per-stage fingerprints chain: ``fp[i] = H(fp[i-1],
    ops[i])`` with each operator hashed shallowly; identity-hashed
    components land in ``pins``, which the caller keeps alive. A host
    boundary raises ``NotImplementedError``: its execution is not ported
    yet.
    """
    from repro_torch.core.fingerprint import fingerprint, node_fingerprint
    from repro_torch.kernels.ops import kernel_mode_token
    from repro_torch.relational.engine import Aggregate, Join

    pins = pins if pins is not None else []
    stages: list[Stage] = []
    prev_fp = ""
    prev_out: Optional[list[str]] = None
    for idx, (kind, ops) in enumerate(plan_segments(plan)):
        if kind != "pure":
            raise NotImplementedError(
                "plans with an MLUdf host boundary are not ported yet: "
                f"see {HOST_BOUNDARY_ITEM}; lower the pipeline whole with "
                "transform='dnn'"
            )
        stage_pins: list = []
        tokens = [node_fingerprint(op, pins=stage_pins) for op in ops]
        # the RAVEN_KERNELS mode changes the program run for Join /
        # Aggregate stages, so it must fork their fingerprints (only theirs)
        extra = (
            [kernel_mode_token()]
            if any(isinstance(op, (Join, Aggregate)) for op in ops)
            else []
        )
        fp = fingerprint("stage", kind, prev_fp, tokens, *extra, pins=stage_pins)
        pins.extend(stage_pins)
        out_cols = _segment_out_cols(ops, prev_out)
        fn: Optional[Callable] = None
        for op in ops:
            fn = pure_step(op, fn)
        stages.append(Stage(
            index=idx, kind=kind, ops=ops, fingerprint=fp,
            out_columns=tuple(out_cols), fn=fn,
        ))
        prev_fp = fp
        prev_out = out_cols
    return StageGraph(plan=plan, stages=stages)


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


@dataclass
class RunResult:
    """One graph execution: the result table, the per-row segment ids it
    carried (None outside coalesced serving), and per-stage wall times."""

    table: Table
    seg: Optional[torch.Tensor]
    timings: list[float] = field(default_factory=list)


def run_graph(graph: StageGraph, env: dict[str, Any]) -> RunResult:
    """Execute a stage graph over an environment, one stage at a time.

    Each stage's time includes its device work: on CUDA the runner
    synchronizes after the stage, as the reference blocks on its results."""
    state: Optional[State] = None
    timings: list[float] = []
    for stage in graph.stages:
        t0 = time.perf_counter()
        state = stage.fn(env)
        if state[1].is_cuda:
            torch.cuda.synchronize(state[1].device)
        dt = time.perf_counter() - t0
        stage.calls += 1
        stage.total_s += dt
        timings.append(dt)
    cols, valid, seg = state
    return RunResult(table=Table(columns=cols, valid=valid), seg=seg,
                     timings=timings)
