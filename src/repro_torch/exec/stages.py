"""StageGraph: the physical stage IR of the execution layer.

Lowering a physical plan produces a graph of :class:`Stage` nodes, each
carrying:

  * its operator slice of the plan (a maximal pure segment, or one MLUdf
    host boundary),
  * its output columns,
  * a canonical per-stage content fingerprint (chained through upstream
    stages, so a stage's hash identifies *this stage of this plan*),
  * runtime accounting (calls, wall time).

Execution threads a three-part state ``(columns, valid, seg)`` through the
stages: ``valid`` is the row-validity mask that makes padded serving exact,
and ``seg`` is an optional per-row request-segment id that lets aggregates
fold per request instead of per batch.

A pure stage is its composed ``env -> state`` function; the engine
installs a ``runner`` on it (:mod:`repro_torch.relational.engine`), which on
the card captures the function into one CUDA graph per input shape and
replays it (the port's ``jax.jit``), and on the CPU runs it eagerly. A host
stage is the interpreted ML runtime: the rows cross to the host once (a
wait on the card, a copy down, compaction to the valid rows), the numpy
pipeline runs over them, and its output goes back up as the ``__mid__``
pseudo-table the next pure stage starts from. Each stage also carries its
schema: the tables and columns it reads and its ``:param`` slots.

The runner (:func:`run_graph`) accepts a ``bucketer`` so the serving layer
can re-pad rows to a power-of-two bucket at every host-boundary exit, not
just at query entry: that keeps post-UDF stages on graphs already captured.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.relational.expr import eval_expr, params_of
from repro_torch.relational.table import Table, to_device

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
# the key, in a dimsort entry, of the Join step's cache of sorted payloads
# (built on first use): a cache, not an input, so no key of a stage runner
# includes it
DIMSORT_CACHE = "payloads"
# arange(num_segment_slots): its length tells segmented aggregates their
# output width (slot count is power-of-two bucketed)
SEG_SLOTS_KEY = "__seg_slots__"
# runtime scalar: how many of the segment slots are real requests
SEG_COUNT_KEY = "__seg_count__"

# pseudo-table carrying a host boundary's output into the next pure stage
MID_TABLE = "__mid__"
MID_VALID = "__valid__"
MID_SEG = "__seg__"

# state threaded through stages: (columns, valid-mask, segment-ids-or-None)
State = tuple[dict[str, torch.Tensor], torch.Tensor, Optional[torch.Tensor]]

# env keys that are per-execution (single-use) rather than database-resident:
# on the card a captured stage copies them into its graph's static buffers on
# every replay (with the tables named in a run's ``donate`` set), while the
# resident tables are read where they lie
VOLATILE_KEYS = (ROW_VALID_KEY, ROW_SEG_KEY, MID_TABLE, PARAMS_KEY,
                 SEG_SLOTS_KEY, SEG_COUNT_KEY)


def donation_enabled(device) -> bool:
    """Whether a run's donated entry inputs are dropped from the env once
    the entry stage has consumed them (:func:`strip_consumed`), so later
    stages neither see nor key on them. On the card the donated tables are
    copied into the entry stage's graph buffers, which every replay reuses:
    the port's counterpart of donating buffers to XLA. On by default on the
    card, off on the CPU (as the reference leaves it off on XLA:CPU);
    ``RAVEN_DONATE=1``/``0`` forces it either way."""
    flag = os.environ.get("RAVEN_DONATE")
    if flag is not None:
        return flag not in ("0", "false", "")
    return torch.device(device).type == "cuda"


def seg_bucket(k: int, min_bucket: int = 4) -> int:
    """Power-of-two segment-slot bucket for ``k`` coalesced requests."""
    b = max(int(min_bucket), 1)
    while b < k:
        b <<= 1
    return b


# ---------------------------------------------------------------------------
# Pure-operator steps (env -> State composition)
# ---------------------------------------------------------------------------


def pure_step(plan, inner: Optional[Callable[[dict], State]],
              kernels: Optional[bool] = None) -> Callable[[dict], State]:
    """Compose one pure operator on top of ``inner`` (env -> state).
    ``kernels`` is the relational-kernel mode of Join and Aggregate (None:
    the ``RAVEN_KERNELS`` knob's)."""
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

        use_kernels = kernels_enabled() if kernels is None else kernels

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
        consts: dict = {}  # the expression's constants, once per device

        def fn(env, _plan=plan, _consts=consts):
            cols, valid, seg = inner(env)
            keep = eval_expr(_plan.expr, cols, env.get(PARAMS_KEY), consts=_consts)
            return cols, valid & keep.to(torch.bool), seg
        return fn

    if isinstance(plan, Project):
        consts = {}

        def fn(env, _plan=plan, _consts=consts):
            cols, valid, seg = inner(env)
            keep = _plan.keep if _plan.keep is not None else list(cols)
            out = {c: cols[c] for c in keep}
            for name, e in _plan.exprs.items():
                out[name] = eval_expr(e, cols, env.get(PARAMS_KEY), consts=_consts)
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

        use_kernels = kernels_enabled() if kernels is None else kernels

        def fn(env, _plan=plan, _kern=use_kernels):
            from repro_torch.tensor.compile import emit_aggregate_kernel

            cols, valid, seg = inner(env)
            w = valid.to(torch.float32)
            one = torch.ones((1,), dtype=torch.bool, device=valid.device)
            if seg is None:
                # global fold: a single output row; the upstream filter is
                # already folded in as the validity weight
                if _kern:
                    out = emit_aggregate_kernel(_plan.aggs, cols, w, None, 1)
                    return out, one, None
                sid0 = torch.zeros_like(valid, dtype=torch.int32)
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


def _from_mid(env) -> State:
    """Stage entry for operators sitting on top of a host boundary: the
    boundary's output arrives re-wrapped as the ``__mid__`` pseudo-table."""
    cols = dict(env[MID_TABLE])
    valid = cols.pop(MID_VALID)
    seg = cols.pop(MID_SEG, None)
    return cols, valid, seg


# ---------------------------------------------------------------------------
# Stage / StageGraph
# ---------------------------------------------------------------------------


@dataclass
class Stage:
    """One node of the stage graph.

    ``kind == "pure"`` stages own a maximal pure operator segment, run as
    ``fn`` on the plan's device through ``runner`` (captured on the card);
    ``kind == "host"`` stages own one MLUdf boundary (``udf``) and run
    interpreted on the host. ``fingerprint`` is a canonical content hash of
    this stage's operators chained through every upstream stage's hash.
    ``reads`` and ``params`` are the env tables (and their columns) and the
    ``:param`` slots the stage reads, ``in_columns`` the upstream stage's
    columns it consumes. ``traces`` counts the stage's
    specializations: captures on the card, first calls of an input
    structure on the CPU; ``disk_loads`` those that came from the artifact
    store instead (:mod:`repro_torch.exec.artifact_store`), which keys its
    entries on ``fingerprint`` only where ``content_stable`` (no component
    of the chained hash was hashed by identity). A host stage sums its time by part in ``host_s``:
    ``sync`` (waiting for the card), ``down`` (the copy to the host and the
    compaction to valid rows), ``udf`` (the interpreter) and ``up`` (the
    copy back to the device).
    """

    index: int
    kind: str  # "pure" | "host"
    ops: list  # plan-node slice, innermost first
    fingerprint: str
    out_columns: tuple[str, ...]
    reads: dict[str, tuple[str, ...]] = field(default_factory=dict)
    # upstream-stage columns consumed: a pure stage's whole upstream schema
    # (None for the entry stage), a host stage's pipeline inputs
    in_columns: Optional[tuple[str, ...]] = None
    params: frozenset[str] = frozenset()
    fn: Optional[Callable[[dict], State]] = None  # pure: raw env -> state
    runner: Optional[Callable[..., State]] = None  # pure: fn behind capture
    udf: Any = None  # host: the MLUdf plan node
    # False when the chained fingerprint involves an identity-hashed (id())
    # component: valid only in this process, so the artifact store never
    # keys an entry on it
    content_stable: bool = True
    traces: int = 0
    calls: int = 0
    total_s: float = 0.0
    host_s: dict[str, float] = field(default_factory=dict)
    # pipelined execution: executions dispatched without waiting for the
    # card (dispatch_s is the enqueue cost), and for host stages the wall
    # time spent on the boundary pool
    async_calls: int = 0
    dispatch_s: float = 0.0
    # bucket structures served from the artifact store instead of being
    # specialized live in this process (warm-start preloads and lazy hits)
    disk_loads: int = 0

    @property
    def label(self) -> str:
        """Compact operator chain, e.g. ``Scan[patients]→Filter``."""
        return "→".join(_op_label(op) for op in self.ops)


@dataclass
class StageGraph:
    """The lowered physical plan: a linear chain of stages."""

    plan: Any  # the PhysicalPlan this graph was lowered from
    stages: list[Stage]

    @property
    def is_pure(self) -> bool:
        """One pure stage, no host boundary (MLtoSQL/MLtoDNN output)."""
        return all(s.kind == "pure" for s in self.stages)

    @property
    def n_host_boundaries(self) -> int:
        return sum(1 for s in self.stages if s.kind == "host")

    @property
    def has_aggregate(self) -> bool:
        from repro_torch.relational.engine import Aggregate

        return any(
            isinstance(op, Aggregate) for s in self.stages for op in s.ops
        )

    @property
    def needs_segments(self) -> bool:
        """True when per-request splitting of a coalesced batch requires
        segment ids: row alignment with the input spine is lost at host
        boundaries (compaction) and at aggregates (folding)."""
        return not self.is_pure or self.has_aggregate

    @property
    def traces(self) -> int:
        return sum(s.traces for s in self.stages)


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
    if name == "MLUdf":
        return f"MLUdf[{op.pipeline.n_ops()}-op]"
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
        MLUdf,
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
        elif isinstance(op, (MLUdf, TensorOp)):
            cur = [c for c in cur if c not in op.consumes]
            cur = cur + [c for c in op.output_names if c not in cur]
        elif isinstance(op, Aggregate):
            cur = [a[0] for a in op.aggs]
        else:
            raise TypeError(type(op))
    return cur


def _segment_reads(ops) -> dict[str, tuple[str, ...]]:
    """Env tables (and their columns) this segment reads directly."""
    from repro_torch.relational.engine import Join, Scan

    reads: dict[str, list[str]] = {}
    for op in ops:
        if isinstance(op, Scan):
            reads.setdefault(op.table, []).extend(op.columns)
        elif isinstance(op, Join):
            cols = reads.setdefault(op.dim_table, [])
            for c in [op.dim_key, *op.dim_columns]:
                if c not in cols:
                    cols.append(c)
    return {t: tuple(cs) for t, cs in reads.items()}


def _segment_params(ops) -> frozenset[str]:
    from repro_torch.relational.engine import Filter, Project

    names: set[str] = set()
    for op in ops:
        if isinstance(op, Filter):
            names |= params_of(op.expr)
        elif isinstance(op, Project):
            for e in op.exprs.values():
                names |= params_of(e)
    return frozenset(names)


def build_stage_graph(plan, pins: Optional[list] = None,
                      kernels: Optional[bool] = None) -> StageGraph:
    """Lower a physical plan into its :class:`StageGraph`.

    Each pure segment gets an ``env -> state`` callable composed from
    :func:`pure_step` (a pure stage after a host stage starts from the
    ``__mid__`` pseudo-table); each host segment carries its MLUdf node.
    Per-stage fingerprints chain: ``fp[i] = H(fp[i-1], ops[i])`` with each
    operator hashed shallowly; identity-hashed components land in ``pins``,
    which the caller keeps alive, and mark the stage (and every stage after
    it, whose chained hash embeds it) ``content_stable=False``.
    ``kernels`` is the relational-kernel mode (None: ``RAVEN_KERNELS``'s).
    """
    from repro_torch.core.fingerprint import fingerprint, node_fingerprint
    from repro_torch.kernels.ops import kernel_mode_token
    from repro_torch.relational.engine import Aggregate, Join

    pins = pins if pins is not None else []
    stages: list[Stage] = []
    prev_fp = ""
    prev_out: Optional[list[str]] = None
    prev_stable = True
    for idx, (kind, ops) in enumerate(plan_segments(plan)):
        stage_pins: list = []
        tokens = [node_fingerprint(op, pins=stage_pins) for op in ops]
        # the RAVEN_KERNELS mode changes the program run for Join /
        # Aggregate stages, so it must fork their fingerprints (only theirs)
        extra = (
            [kernel_mode_token(kernels)]
            if any(isinstance(op, (Join, Aggregate)) for op in ops)
            else []
        )
        fp = fingerprint("stage", kind, prev_fp, tokens, *extra, pins=stage_pins)
        stable = prev_stable and not stage_pins
        pins.extend(stage_pins)
        out_cols = _segment_out_cols(ops, prev_out)
        if kind == "pure":
            fn: Optional[Callable] = None if idx == 0 else _from_mid
            for op in ops:
                fn = pure_step(op, fn, kernels)
            stage = Stage(index=idx, kind=kind, ops=ops, fingerprint=fp,
                          out_columns=tuple(out_cols), reads=_segment_reads(ops),
                          in_columns=tuple(prev_out) if prev_out is not None else None,
                          params=_segment_params(ops), fn=fn, content_stable=stable)
        else:
            stage = Stage(index=idx, kind=kind, ops=ops, fingerprint=fp,
                          out_columns=tuple(out_cols),
                          in_columns=tuple(ops[0].pipeline.input_names()),
                          udf=ops[0], content_stable=stable)
        stages.append(stage)
        prev_fp = fp
        prev_out = out_cols
        prev_stable = stable
    return StageGraph(plan=plan, stages=stages)


# ---------------------------------------------------------------------------
# Host-boundary (MLUdf) execution
# ---------------------------------------------------------------------------


def run_udf(udf, cols: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Batch-at-a-time interpreted pipeline execution (host)."""
    from repro_torch.ml.pipeline import run_pipeline

    n = len(next(iter(cols.values())))
    in_names = udf.pipeline.input_names()
    outs: dict[str, list[np.ndarray]] = {o: [] for o in udf.pipeline.outputs}
    bs = udf.batch_size
    for s in range(0, max(n, 1), bs):
        batch = {k: cols[k][s : s + bs] for k in in_names}
        if len(next(iter(batch.values()))) == 0:
            continue
        res = run_pipeline(udf.pipeline, batch)
        for o in udf.pipeline.outputs:
            outs[o].append(np.asarray(res[o]))
    if n == 0:
        # run the pipeline over the zero-row slice anyway: outputs must keep
        # their true trailing shape (split-lowering block columns are 2-D),
        # or the downstream pure stage would see the wrong rank
        res = run_pipeline(udf.pipeline, {k: cols[k][:0] for k in in_names})
        for o in udf.pipeline.outputs:
            outs[o].append(np.asarray(res[o]))
    result = dict(cols)
    for o, name in zip(udf.pipeline.outputs, udf.output_names):
        result[name] = np.concatenate(outs[o])
    for c in udf.consumes:  # block columns ending at this boundary (split)
        if c not in udf.output_names:
            result.pop(c, None)
    return result


def env_device(env: dict[str, Any]) -> torch.device:
    """The device of an execution environment: that of its first tensor."""
    walk = list(env.values())
    while walk:
        v = walk.pop(0)
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, dict):
            walk = list(v.values()) + walk
    raise ValueError("the environment holds no tensor")


def call_pure(stage: Stage, env: dict[str, Any],
              donate: frozenset = frozenset()) -> State:
    """Invoke one pure stage: the runner when the engine installed one (it
    knows the donated, single-use tables), else the raw composed fn."""
    if stage.runner is not None:
        return stage.runner(env, donate=donate)
    return stage.fn(env)


def strip_consumed(env: dict[str, Any], donate: frozenset) -> dict[str, Any]:
    """Drop the entry stage's single-use inputs from the env once consumed.

    Under donation (:func:`donation_enabled`) the entry stage has copied
    the donated tables and the row-validity/segment vectors into its
    graph's buffers, so later stages need not see them, and their keys do
    not depend on them; without donation this is a no-op, so the env
    structure (and every specialization already made) is unchanged from
    the serial, non-donating layout."""
    if not donate or not donation_enabled(env_device(env)):
        return env
    drop = set(donate) | {ROW_VALID_KEY, ROW_SEG_KEY}
    return {k: v for k, v in env.items() if k not in drop}


def host_step(
    stage: Stage,
    state: State,
    env: dict[str, Any],
    *,
    bucketer: Optional[Callable[[int], int]] = None,
    on_mid_bucket: Optional[Callable[[int, int], None]] = None,
    ready: Optional["torch.cuda.Event"] = None,
) -> tuple[State, dict[str, Any]]:
    """Run one MLUdf host boundary: wait for the upstream state on the
    card, copy it to the host and compact it to valid rows, run the
    interpreted pipeline, re-pad the output to a shape bucket, and upload it
    as the ``__mid__`` pseudo-table.

    The wait is on ``ready``, an event recorded after the upstream stage
    was enqueued (the pipelined executor's, on another thread), or else on
    one recorded here on the current stream: never on the whole device, so
    other request groups' work keeps running. A graph cannot span this
    boundary: the stages on either side are captured apart, and the
    boundary's wait and copies run eagerly.

    Uploads demote 64-bit outputs to 32-bit (the interpreter's float64
    scores and int64 labels), as the reference's ``jnp.asarray`` does, so
    the next stage computes on the reference's dtypes. ``bucketer`` (the
    serving layer's) maps the compacted row count to a padded bucket, so
    the next pure stage sees power-of-two shapes, pad rows invalid;
    ``on_mid_bucket(stage_index, bucket)`` lets the caller account the
    buckets. Returns the new state and the env (with ``__mid__`` installed)
    for the downstream stages.
    """
    from repro_torch.exec.faults import maybe_inject

    # "udf" fault site: the interpreted ML runtime raises at the host
    # boundary (the Spark→Python-UDF failure mode), before any wait
    maybe_inject("udf", token=stage.fingerprint)
    cols, valid, seg = state
    device = valid.device
    t0 = time.perf_counter()
    if valid.is_cuda:
        if ready is None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))
        ready.synchronize()
    t1 = time.perf_counter()
    mask = valid.cpu().numpy()
    np_cols = {k: v.cpu().numpy()[mask] for k, v in cols.items()}  # compact
    np_seg = seg.cpu().numpy()[mask] if seg is not None else None
    t2 = time.perf_counter()
    out = run_udf(stage.udf, np_cols)
    n = len(next(iter(out.values()))) if out else 0
    b = bucketer(n) if bucketer is not None else n
    if b > n:
        out = {
            k: np.concatenate([v, np.zeros((b - n,) + v.shape[1:], dtype=v.dtype)])
            for k, v in out.items()
        }
        if np_seg is not None:
            np_seg = np.concatenate([np_seg, np.zeros(b - n, dtype=np_seg.dtype)])
    if on_mid_bucket is not None:
        on_mid_bucket(stage.index, b)
    t3 = time.perf_counter()
    mid = {k: to_device(v, device) for k, v in out.items()}
    mid[MID_VALID] = torch.from_numpy(np.arange(b) < n).to(device)
    if np_seg is not None:
        mid[MID_SEG] = to_device(np_seg.astype(np.int32), device)
    t4 = time.perf_counter()
    for part, dt in (("sync", t1 - t0), ("down", t2 - t1), ("udf", t3 - t2),
                     ("up", t4 - t3)):
        stage.host_s[part] = stage.host_s.get(part, 0.0) + dt
    env = dict(env)
    env[MID_TABLE] = mid
    return _from_mid(env), env


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


def run_graph(
    graph: StageGraph,
    env: dict[str, Any],
    *,
    bucketer: Optional[Callable[[int], int]] = None,
    on_mid_bucket: Optional[Callable[[int, int], None]] = None,
    donate: frozenset = frozenset(),
) -> RunResult:
    """Execute a stage graph over an environment, one stage at a time.

    Each stage's time includes its device work: on CUDA the runner
    synchronizes after a pure stage (outside any capture), as the reference
    blocks on its results. ``bucketer`` (the serving layer's) maps a host
    boundary's compacted row count to a padded bucket, so the next pure
    stage sees power-of-two shapes; ``on_mid_bucket(stage_index, bucket)``
    lets the caller account those buckets. Without a ``bucketer`` the
    boundary output runs at its exact compacted shape (the one-shot path).
    ``donate`` names env tables that are single-use (the serving layer's
    freshly padded fact spine, a one-shot call's batch).

    The pipelined executor in :mod:`repro_torch.exec.pipeline` runs the same
    stages (the same graphs, the same env structure) with host and device
    work overlapped across request groups."""
    state: Optional[State] = None
    timings: list[float] = []
    for stage in graph.stages:
        t0 = time.perf_counter()
        if stage.kind == "pure":
            state = call_pure(stage, env, donate)
            if state[1].is_cuda:
                torch.cuda.synchronize(state[1].device)
            if stage.index == 0:
                env = strip_consumed(env, donate)
        else:
            state, env = host_step(
                stage, state, env,
                bucketer=bucketer, on_mid_bucket=on_mid_bucket,
            )
        dt = time.perf_counter() - t0
        stage.calls += 1
        stage.total_s += dt
        timings.append(dt)
    cols, valid, seg = state
    return RunResult(table=Table(columns=cols, valid=valid), seg=seg,
                     timings=timings)
