"""Static verifier for logical plans and the lowered StageGraph IR.

Three layers of checks, all reporting through the typed rule registry in
:mod:`repro_torch.analysis.rules`:

  * **logical** (:func:`check_logical`) — cheap invariants of the
    PredictionQuery, run differentially by the optimizer after every rewrite
    rule so a violation names the rule that introduced it;
  * **graph** (:func:`check_graph`) — structural invariants of the lowered
    stage chain: schema chaining, ``__pv_*`` consumes-balance, runtime
    placement, residual minimality, fingerprint hygiene;
  * **exec** (:func:`check_exec`) — abstract execution at two row buckets:
    every pure stage's body runs eagerly on zero-filled inputs of the
    bucket's size, on the database's device (else the card, or the CPU
    when asked) with the plan's programs moved there, and must emit exactly its
    declared schema with bucket-invariant dtypes and be row-polymorphic (so
    warm re-bucketing cannot capture again). Host stages run for real on a
    zero-row batch (cheap, and exactly what serving does to discover
    trailing shapes).

Modes: ``off`` (skip), ``warn`` (``VerificationWarning`` + report lines),
``strict`` (raise :class:`~repro_torch.errors.PlanVerificationError`). The
mode defaults to the ``RAVEN_VERIFY`` environment variable so CI can force
``strict`` without touching call sites.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.analysis import rules as R
from repro_torch.analysis.rules import Violation, violation

# reserved block-column prefix (split-lowering cut values)
from repro_torch.ml.pipeline import cut_column
from repro_torch.relational.table import to_device

BLOCK_PREFIX = cut_column("")

_MODES = ("off", "warn", "strict")


def resolve_verify_mode(value: Any = None) -> str:
    """Normalize a user-supplied verify mode.

    ``None`` defers to ``RAVEN_VERIFY`` (default ``off``); booleans map to
    ``strict``/``off``; strings must be one of ``off``/``warn``/``strict``.
    """
    if value is None:
        value = os.environ.get("RAVEN_VERIFY") or "off"
    if isinstance(value, bool):
        value = "strict" if value else "off"
    if value not in _MODES:
        raise ValueError(
            f"verify mode must be one of {_MODES}, got {value!r}"
        )
    return value


def enforce(
    violations: list[Violation], mode: str, context: str = "plan"
) -> list[str]:
    """Apply a verify mode to a violation list.

    Returns human-readable report lines (for ``explain()``); raises
    :class:`PlanVerificationError` under ``strict``, emits a
    :class:`VerificationWarning` under ``warn``.
    """
    if mode == "off" or not violations:
        return [] if mode == "off" else [f"{context}: ok"]
    lines = [f"{context}: {v}" for v in violations]
    if mode == "strict":
        from repro_torch.errors import PlanVerificationError

        raise PlanVerificationError(
            f"plan verification failed ({context}):\n  "
            + "\n  ".join(str(v) for v in violations),
            violations=violations,
        )
    import warnings

    for ln in lines:
        warnings.warn(ln, R.VerificationWarning, stacklevel=3)
    return lines


# ---------------------------------------------------------------------------
# Logical checks (differential, per rewrite rule)
# ---------------------------------------------------------------------------


def check_logical(query, where: str = "") -> list[Violation]:
    """Invariants of a PredictionQuery's logical plan."""
    from repro_torch.core.ir import (
        LAggregate,
        LFilter,
        LJoin,
        LPredict,
        LProject,
        LScan,
    )
    from repro_torch.relational.expr import columns_of

    out: list[Violation] = []

    def pipe_check(pred: LPredict) -> None:
        pipe = pred.pipeline
        try:
            pipe.copy().toposort()
        except ValueError as e:
            out.append(violation(R.PIPELINE_GRAPH, str(e), where))
            return
        produced: set[str] = set(pipe.input_names())
        for n in pipe.nodes:
            for o in n.outputs:
                if o in produced:
                    out.append(violation(
                        R.PIPELINE_GRAPH,
                        f"value {o!r} has multiple producers", where,
                    ))
                produced.add(o)
        for o in pipe.outputs:
            if o not in produced:
                out.append(violation(
                    R.PIPELINE_GRAPH,
                    f"declared output {o!r} is never produced", where,
                ))

    def avail(p) -> list[str]:
        if isinstance(p, LScan):
            return list(p.columns)
        cols = avail(p.child)
        have = set(cols)

        def need(names, what):
            missing = [c for c in names if c not in have]
            if missing:
                out.append(violation(
                    R.LOGICAL_SCHEMA,
                    f"{what} references missing column(s) {missing} "
                    f"(child provides {sorted(have)})", where,
                ))

        if isinstance(p, LJoin):
            need([p.fact_key], "join key")
            return cols + list(p.dim_columns)
        if isinstance(p, LFilter):
            need(sorted(columns_of(p.expr)), "filter predicate")
            return cols
        if isinstance(p, LProject):
            if p.keep is not None:
                need(list(p.keep), "projection keep-list")
            for name, e in p.exprs.items():
                need(sorted(columns_of(e)), f"projection expr {name!r}")
            base = list(p.keep) if p.keep is not None else cols
            return base + [c for c in p.exprs if c not in base]
        if isinstance(p, LPredict):
            pipe_check(p)
            need(p.pipeline.input_names(), "predict pipeline inputs")
            return cols + list(p.output_names)
        if isinstance(p, LAggregate):
            for _, op, col in p.aggs:
                if op != "count":
                    need([col], f"aggregate {op}")
            return [a[0] for a in p.aggs]
        raise TypeError(type(p))

    avail(query.plan)
    return out


# ---------------------------------------------------------------------------
# Structural graph checks
# ---------------------------------------------------------------------------


def _op_reads(op) -> Optional[tuple[str, ...]]:
    """Columns an ML operator consumes from its input schema, when known.

    MLUdf declares them via its pipeline; TensorOp closures are opaque
    except for the ``__input_names__`` schema the tensor compiler stamps.
    Returns ``None`` when unknowable (untagged TensorOp closure).
    """
    from repro_torch.relational.engine import MLUdf, TensorOp

    if isinstance(op, MLUdf):
        return tuple(op.pipeline.input_names())
    if isinstance(op, TensorOp):
        ins = getattr(op.fn, "__input_names__", None)
        return tuple(ins) if ins is not None else None
    return ()


def check_graph(graph) -> list[Violation]:
    """Structural invariants of a lowered :class:`StageGraph`."""
    out: list[Violation] = []
    out += _check_graph_shape(graph)
    out += _check_schema_chain(graph)
    out += _check_consumes_balance(graph)
    out += _check_block_leak(graph)
    out += _check_placement(graph)
    out += _check_residual_minimal(graph)
    out += _check_fingerprint_stable(graph)
    out += _check_fingerprint_deterministic(graph)
    return out


def _check_graph_shape(graph) -> list[Violation]:
    from repro_torch.relational.engine import MLUdf, Scan

    out: list[Violation] = []
    if not graph.stages:
        return [violation(R.GRAPH_SHAPE, "graph has no stages")]
    for i, s in enumerate(graph.stages):
        w = f"stage {i}"
        if s.index != i:
            out.append(violation(
                R.GRAPH_SHAPE, f"index {s.index} != position {i}", w))
        if s.kind not in ("pure", "host"):
            out.append(violation(R.GRAPH_SHAPE, f"unknown kind {s.kind!r}", w))
            continue
        if s.kind == "pure":
            if s.fn is None:
                out.append(violation(R.GRAPH_SHAPE, "pure stage has no fn", w))
            if s.udf is not None:
                out.append(violation(
                    R.GRAPH_SHAPE, "pure stage carries a udf", w))
            if i > 0 and graph.stages[i - 1].kind == "pure":
                out.append(violation(
                    R.GRAPH_SHAPE,
                    "adjacent pure stages (segments must be maximal)", w))
        else:
            if s.udf is None or len(s.ops) != 1 or not isinstance(
                s.ops[0], MLUdf
            ):
                out.append(violation(
                    R.GRAPH_SHAPE,
                    "host stage must carry exactly one MLUdf", w))
    first = graph.stages[0]
    if not first.ops or not isinstance(first.ops[0], Scan):
        out.append(violation(
            R.GRAPH_SHAPE, "graph does not start at a Scan", "stage 0"))
    return out


def _check_schema_chain(graph) -> list[Violation]:
    from repro_torch.exec.stages import _segment_out_cols

    out: list[Violation] = []
    prev_out: Optional[tuple[str, ...]] = None
    for s in graph.stages:
        w = f"stage {s.index} ({s.label})"
        if prev_out is not None:
            if s.kind == "pure" and s.in_columns != prev_out:
                out.append(violation(
                    R.SCHEMA_CHAIN,
                    f"in_columns {s.in_columns} != upstream out_columns "
                    f"{prev_out}", w))
            elif s.kind == "host" and s.in_columns is not None:
                missing = [c for c in s.in_columns if c not in prev_out]
                if missing:
                    out.append(violation(
                        R.SCHEMA_CHAIN,
                        f"host stage reads {missing} absent from upstream "
                        f"out_columns {prev_out}", w))
        try:
            inferred = tuple(_segment_out_cols(
                s.ops, list(prev_out) if prev_out is not None else None))
        except TypeError:
            inferred = None
        if inferred is not None and tuple(s.out_columns) != inferred:
            out.append(violation(
                R.SCHEMA_CHAIN,
                f"declared out_columns {tuple(s.out_columns)} != inferred "
                f"{inferred}", w))
        prev_out = tuple(s.out_columns)
    return out


def _check_consumes_balance(graph) -> list[Violation]:
    from repro_torch.relational.engine import MLUdf, TensorOp

    out: list[Violation] = []
    produced: dict[str, str] = {}
    consumed: dict[str, str] = {}
    for stage in graph.stages:
        for op in stage.ops:
            label = f"stage {stage.index} {type(op).__name__}"
            reads = _op_reads(op)
            if reads:
                for c in reads:
                    if not c.startswith(BLOCK_PREFIX):
                        continue
                    if c in consumed:
                        out.append(violation(
                            R.CONSUMES_BALANCE,
                            f"block column {c!r} read after being consumed "
                            f"by {consumed[c]}", label))
                    elif c not in produced:
                        out.append(violation(
                            R.CONSUMES_BALANCE,
                            f"block column {c!r} read but never produced "
                            f"upstream", label))
            for c in getattr(op, "consumes", ()) or ():
                if c not in produced:
                    out.append(violation(
                        R.CONSUMES_BALANCE,
                        f"consumes {c!r} which no upstream operator "
                        f"produced", label))
                elif c in consumed:
                    out.append(violation(
                        R.CONSUMES_BALANCE,
                        f"block column {c!r} consumed twice (first by "
                        f"{consumed[c]})", label))
                else:
                    consumed[c] = label
                if reads is not None and c not in reads:
                    out.append(violation(
                        R.CONSUMES_BALANCE,
                        f"consumes {c!r} without reading it", label))
            if isinstance(op, (MLUdf, TensorOp)):
                for c in op.output_names:
                    if c.startswith(BLOCK_PREFIX):
                        produced[c] = label
    for c, label in produced.items():
        if c not in consumed:
            out.append(violation(
                R.CONSUMES_BALANCE,
                f"block column {c!r} produced by {label} but never "
                f"consumed", label))
    return out


def _check_block_leak(graph) -> list[Violation]:
    leaked = [
        c for c in graph.stages[-1].out_columns
        if c.startswith(BLOCK_PREFIX)
    ] if graph.stages else []
    if leaked:
        return [violation(
            R.BLOCK_LEAK,
            f"reserved block column(s) {leaked} leak into the query "
            f"output schema",
            f"stage {graph.stages[-1].index}")]
    return []


def _check_placement(graph) -> list[Violation]:
    from repro_torch.relational.engine import (
        Aggregate, Filter, Join, MLUdf, Project, Scan, TensorOp,
    )

    pure_ok = (Scan, Join, Filter, Project, TensorOp, Aggregate)
    out: list[Violation] = []
    for s in graph.stages:
        w = f"stage {s.index} ({s.label})"
        for op in s.ops:
            if s.kind == "pure" and not isinstance(op, pure_ok):
                out.append(violation(
                    R.PLACEMENT_PURE,
                    f"host-only operator {type(op).__name__} inside a pure "
                    f"stage", w))
            elif s.kind == "host" and not isinstance(op, MLUdf):
                out.append(violation(
                    R.PLACEMENT_PURE,
                    f"pure operator {type(op).__name__} inside a host "
                    f"stage", w))
    return out


def _check_residual_minimal(graph) -> list[Violation]:
    from repro_torch.ml.pipeline import split_pipeline
    from repro_torch.tensor.compile import tensor_supported

    out: list[Violation] = []
    for s in graph.stages:
        if s.kind != "host" or s.udf is None:
            continue
        udf = s.udf
        split_context = bool(udf.consumes) or any(
            c.startswith(BLOCK_PREFIX)
            for c in [*udf.pipeline.input_names(), *udf.output_names]
        )
        if not split_context:
            # monolithic MLUdf: the optimizer chose the host runtime for
            # the whole pipeline (transform='none'); minimality not claimed
            continue
        w = f"stage {s.index} ({s.label})"
        try:
            resplit = split_pipeline(udf.pipeline, tensor_supported)
        except Exception as e:  # corrupt pipeline: report, don't crash
            out.append(violation(
                R.RESIDUAL_MINIMAL,
                f"re-split of residual failed: {e}", w))
            continue
        if resplit.fully_supported:
            out.append(violation(
                R.RESIDUAL_MINIMAL,
                "residual pipeline is fully tensor-supported — it should "
                "not be a host boundary at all", w))
        elif resplit.prefix is not None or resplit.suffix is not None:
            extra = [
                seg for seg, part in
                (("prefix", resplit.prefix), ("suffix", resplit.suffix))
                if part is not None
            ]
            out.append(violation(
                R.RESIDUAL_MINIMAL,
                f"residual is not minimal: re-splitting extracts a tensor "
                f"{' and '.join(extra)}", w))
    return out


_ADDR_RE = re.compile(r"\b0x[0-9a-fA-F]{6,}\b|\bat 0x")


def _iter_tokens(graph):
    """Yield ``(where, token)`` for every fingerprint token in the graph."""
    from repro_torch.relational.engine import MLUdf, TensorOp

    for s in graph.stages:
        for op in s.ops:
            if isinstance(op, TensorOp):
                tok = getattr(op.fn, "__fingerprint_token__", None)
                if isinstance(tok, str):
                    yield f"stage {s.index} TensorOp.fn", tok
            elif isinstance(op, MLUdf):
                for n in op.pipeline.nodes:
                    for v in n.attrs.values():
                        tok = getattr(v, "__fingerprint_token__", None)
                        if isinstance(tok, str):
                            yield (
                                f"stage {s.index} pipeline op "
                                f"{n.op} attr", tok,
                            )


def _check_fingerprint_stable(graph) -> list[Violation]:
    from repro_torch.exec.stages import build_stage_graph

    out: list[Violation] = []
    rebuilt = build_stage_graph(graph.plan)
    if len(rebuilt.stages) != len(graph.stages):
        out.append(violation(
            R.FINGERPRINT_STABLE,
            f"re-lowering produced {len(rebuilt.stages)} stages, graph has "
            f"{len(graph.stages)}"))
    else:
        for a, b in zip(graph.stages, rebuilt.stages):
            if a.fingerprint != b.fingerprint:
                out.append(violation(
                    R.FINGERPRINT_STABLE,
                    f"chained fingerprint not reproducible: "
                    f"{a.fingerprint[:12]}… != {b.fingerprint[:12]}…",
                    f"stage {a.index} ({a.label})"))
    for where, tok in _iter_tokens(graph):
        if _ADDR_RE.search(tok):
            out.append(violation(
                R.FINGERPRINT_STABLE,
                f"fingerprint token embeds a memory-address repr: "
                f"{tok[:60]!r}", where))
    return out


def _replanted(p):
    """Rebuild a physical plan from fresh node and container objects.

    Exprs, closures, and pipelines are kept by reference (identity-hashed
    components must stay identical); everything rebuilt here — node
    dataclasses, lists, tuples, dicts — must not affect a content-addressed
    fingerprint. Plans are short linear chains, so recursion is safe where
    ``copy.deepcopy`` (through MLtoSQL's deep Case chains) would not be.
    """
    import dataclasses

    from repro_torch.relational.engine import plan_children

    kids = plan_children(p)
    changes: dict[str, Any] = {}
    if kids:
        changes["child"] = _replanted(kids[0])
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if f.name == "child":
            continue
        if isinstance(v, list):
            changes[f.name] = list(v)
        elif isinstance(v, tuple):
            changes[f.name] = tuple(v)
        elif isinstance(v, dict):
            changes[f.name] = dict(v)
    return dataclasses.replace(p, **changes)


def _check_fingerprint_deterministic(graph) -> list[Violation]:
    from repro_torch.relational.engine import plan_fingerprint

    pins1: list = []
    pins2: list = []
    fp1 = plan_fingerprint(graph.plan, pins=pins1)
    fp2 = plan_fingerprint(_replanted(graph.plan), pins=pins2)
    if fp1 != fp2:
        return [violation(
            R.FINGERPRINT_DETERMINISTIC,
            f"plan fingerprint changed under node/container rebuild "
            f"({fp1[:12]}… != {fp2[:12]}…) — some component hashes by "
            f"object identity or container order")]
    return []


# ---------------------------------------------------------------------------
# Abstract-execution checks (zero-filled runs at two row buckets)
# ---------------------------------------------------------------------------

# memo: a graph's exec verdict is a pure function of its final chained
# fingerprint (which covers every stage), the source-table schema and the
# device it ran on
_EXEC_MEMO: dict[tuple, list[Violation]] = {}


def _dim_unique(tables, table: str, key: str) -> bool:
    """Whether a dim table's join keys are duplicate-free (what lets the
    Join step take the gather-join kernel)."""
    from repro_torch.relational.engine import Database

    if isinstance(tables, Database):
        return "unique" in tables.dimsort(table, key)
    col = tables[table][key]
    host = col.cpu().numpy() if isinstance(col, torch.Tensor) else np.asarray(col)
    sk = np.sort(host, kind="stable")
    return sk.size == 0 or not bool(np.any(sk[1:] == sk[:-1]))


def _raw_schema(col) -> tuple[str, tuple[int, ...]]:
    """A source column's dtype as given and its trailing shape."""
    if isinstance(col, torch.Tensor):
        return str(col.dtype), tuple(col.shape[1:])
    arr = np.asarray(col)
    return str(arr.dtype), tuple(arr.shape[1:])


def _table_schema_key(graph, tables) -> tuple:
    from repro_torch.relational.engine import Join, walk_plan

    parts = []
    # dim-key uniqueness changes the Join program run (kernel vs torch
    # gather), so it must fork the memo entry even at identical schemas
    for p in walk_plan(graph.plan):
        if isinstance(p, Join) and p.dim_table in tables:
            if p.dim_key in tables[p.dim_table]:
                parts.append(("__dimsort__", p.dim_table,
                              _dim_unique(tables, p.dim_table, p.dim_key)))
    for s in graph.stages:
        for t in sorted(s.reads):
            for c in s.reads[t]:
                parts.append((t, c, *_raw_schema(tables[t][c])))
    return tuple(parts)


def _exec_device(tables, device) -> torch.device:
    """Where the abstract run goes: an uploaded database's own device, else
    ``device`` (default the card)."""
    from repro_torch.device import resolve_device
    from repro_torch.relational.engine import Database

    if isinstance(tables, Database):
        if device is not None and resolve_device(device) != tables.device:
            raise ValueError(
                f"the database lies on {tables.device}; verifying on "
                f"{resolve_device(device)} would run another program"
            )
        return tables.device
    return resolve_device(device)


def check_exec(graph, tables, buckets: tuple[int, int] = (8, 16),
               device=None) -> list[Violation]:
    """Abstractly execute ``graph`` at two row buckets and compare.

    ``tables`` maps table name -> {column -> array or tensor}, or is a
    session's uploaded :class:`~repro_torch.relational.engine.Database`,
    which is read where it lies. The run goes to that database's device,
    else to ``device`` (default the card; ``"cpu"`` when asked), and the
    plan's tensor programs are moved there first, as a run moves them: it
    runs the program that will be served. The fact table's rows are
    replaced by the bucket size, its columns zero-filled; dim tables run as
    they are (their join keys decide the Join program, as at serving).
    Source dtypes follow the port's upload policy for tables
    (:func:`~repro_torch.relational.table.to_device`: 64-bit columns
    demoted to 32-bit), which is what a run computes on. Graphs that read
    non-numeric source columns (string categoricals) are skipped — they
    cannot enter a torch program, and serving feeds them through host
    boundaries where real execution already validates them.
    """
    from repro_torch.relational.engine import Database, place_programs, upload_database

    for s in graph.stages:
        for t, cols in s.reads.items():
            if t not in tables:
                return [violation(
                    R.SCHEMA_EXEC, f"plan reads unknown table {t!r}",
                    f"stage {s.index}")]
            for c in cols:
                if c not in tables[t]:
                    return [violation(
                        R.SCHEMA_EXEC,
                        f"plan reads unknown column {t}.{c}",
                        f"stage {s.index}")]
                v = tables[t][c]
                if not isinstance(v, torch.Tensor) and (
                    np.asarray(v).dtype.kind not in "biufc"
                ):
                    return []  # non-numeric source: skip abstract execution
    dev = _exec_device(tables, device)
    key = (graph.stages[-1].fingerprint, buckets,
           _table_schema_key(graph, tables), str(dev))
    hit = _EXEC_MEMO.get(key)
    if hit is not None:
        return list(hit)
    place_programs(graph.plan, dev)
    fact = graph.stages[0].ops[0].table
    if isinstance(tables, Database):
        base = tables
    else:  # the tables the plan reads besides its fact table, uploaded once
        read = {t for s in graph.stages for t in s.reads if t != fact}
        base = upload_database({t: tables[t] for t in read}, dev)
    out: list[Violation] = []
    results = {}
    for b in buckets:
        results[b] = _abstract_run(graph, tables[fact], base, b, dev, out)
        if results[b] is None:
            break
    b1, b2 = buckets
    if results.get(b1) is not None and results.get(b2) is not None:
        out += _compare_buckets(graph, results[b1], results[b2], b1, b2)
    _EXEC_MEMO[key] = list(out)
    return out


def _abstract_run(graph, fact_cols, base, b: int, dev, out: list[Violation]):
    """One zero-filled run of ``graph`` at ``b`` fact rows on ``dev``.

    Each pure stage's body (``Stage.fn``, not its runner: nothing is
    captured or counted as a trace) runs eagerly on the env the engine
    builds (:func:`~repro_torch.relational.engine.build_env`) from ``base``
    with the fact table replaced by zeros at ``b`` rows in their uploaded
    dtypes: every row valid, ``:param`` slots bound to 0, one request
    segment when the graph needs segment ids. A host stage runs its
    pipeline for real on a zero-row batch, and its outputs are re-padded to
    ``b`` zero rows, uploaded as ``host_step`` uploads them. Returns the
    final state, or None after recording a violation.
    """
    from repro_torch.exec.stages import MID_SEG, MID_TABLE, MID_VALID, _from_mid, run_udf
    from repro_torch.relational.engine import build_env, plan_params

    fact = graph.stages[0].ops[0].table
    zeros = {}
    for c, v in fact_cols.items():
        meta = to_device(v[:0], "cpu")
        zeros[c] = torch.zeros((b,) + tuple(meta.shape[1:]), dtype=meta.dtype,
                               device=dev)
    segs = graph.needs_segments
    env = build_env(
        graph.plan, base.replace(fact, zeros), dev,
        row_valid=torch.ones((b,), dtype=torch.bool, device=dev),
        params={n: 0.0 for n in plan_params(graph.plan)},
        segments=(np.zeros(b, np.int32), 1) if segs else None,
    )

    state = None
    for stage in graph.stages:
        w = f"stage {stage.index} ({stage.label})"
        if stage.kind == "pure":
            try:
                state = stage.fn(env)
            except Exception as e:
                out.append(violation(
                    R.SCHEMA_EXEC,
                    f"abstract execution failed at bucket {b}: "
                    f"{type(e).__name__}: {e}", w))
                return None
            cols, valid, seg = state
            if set(cols) != set(stage.out_columns):
                out.append(violation(
                    R.SCHEMA_EXEC,
                    f"abstract output columns {sorted(cols)} != declared "
                    f"{sorted(stage.out_columns)}", w))
                return None
            if valid.dtype != torch.bool:
                out.append(violation(
                    R.SCHEMA_DTYPE,
                    f"validity mask has dtype {valid.dtype}, expected "
                    f"bool", w))
        else:
            cols, valid, seg = state
            zero = {k: v[:0].cpu().numpy() for k, v in cols.items()}
            try:
                res = run_udf(stage.udf, zero)
            except Exception as e:
                out.append(violation(
                    R.SCHEMA_EXEC,
                    f"zero-row host execution failed: "
                    f"{type(e).__name__}: {e}", w))
                return None
            if set(res) != set(stage.out_columns):
                out.append(violation(
                    R.SCHEMA_EXEC,
                    f"host output columns {sorted(res)} != declared "
                    f"{sorted(stage.out_columns)}", w))
                return None
            mid = {}
            for k, v in res.items():
                arr = np.asarray(v)
                mid[k] = to_device(np.zeros((b,) + arr.shape[1:], arr.dtype), dev)
            mid[MID_VALID] = torch.ones((b,), dtype=torch.bool, device=dev)
            if segs:
                mid[MID_SEG] = torch.zeros((b,), dtype=torch.int32, device=dev)
            env = dict(env)
            env[MID_TABLE] = mid
            state = _from_mid(env)
    return state


def _compare_buckets(graph, s1, s2, b1: int, b2: int) -> list[Violation]:
    out: list[Violation] = []
    last = graph.stages[-1]
    w = f"stage {last.index} ({last.label})"
    cols1, valid1, seg1 = s1
    cols2, valid2, seg2 = s2
    for c in cols1:
        if c not in cols2:
            continue
        if cols1[c].dtype != cols2[c].dtype:
            out.append(violation(
                R.SCHEMA_DTYPE,
                f"column {c!r} drifts dtype across buckets: "
                f"{cols1[c].dtype} at {b1} vs {cols2[c].dtype} at {b2}", w))
        if not cols1[c].shape or not cols2[c].shape:
            continue
        d1, d2 = cols1[c].shape[0], cols2[c].shape[0]
        if d1 != d2 and d1 * b2 != d2 * b1:
            out.append(violation(
                R.BUCKET_SAFETY,
                f"column {c!r} leading dim neither bucket-independent nor "
                f"bucket-proportional ({d1} at {b1} vs {d2} at {b2}) — "
                f"re-bucketing would retrace", w))
    if graph.needs_segments and seg2 is None:
        out.append(violation(
            R.SEGMENT_THREADING,
            "graph needs segment ids but drops them before the final "
            "stage", w))
    return out


# ---------------------------------------------------------------------------
# Convenience front door
# ---------------------------------------------------------------------------


def verify_graph(
    graph,
    tables: Optional[dict] = None,
    *,
    mode: str = "strict",
    context: str = "plan",
    device=None,
) -> list[str]:
    """Run all graph (and, given tables, exec) checks and apply ``mode``;
    the abstract run goes where :func:`check_exec` says."""
    mode = resolve_verify_mode(mode)
    if mode == "off":
        return []
    vs = check_graph(graph)
    if tables is not None:
        vs += check_exec(graph, tables, device=device)
    return enforce(vs, mode, context)


def verify_plan(
    plan,
    tables: Optional[dict] = None,
    *,
    mode: str = "strict",
    context: str = "plan",
    device=None,
) -> list[str]:
    """Lower ``plan`` to a StageGraph and verify it."""
    from repro_torch.exec.stages import build_stage_graph

    mode = resolve_verify_mode(mode)
    if mode == "off":
        return []
    return verify_graph(
        build_stage_graph(plan), tables, mode=mode, context=context,
        device=device,
    )
