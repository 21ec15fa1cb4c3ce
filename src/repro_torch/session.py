"""One front door for prediction queries: sessions, prepared queries, EXPLAIN.

The reference package's user-facing surface over the parser, the unified
IR, the optimizer and the engine, on the port's device::

    import repro_torch as raven

    db = raven.connect(tables, stats="auto")        # tables to the card, once
    db.register_model("risk", pipe)                 # or db.models.publish(...)

    q = db.sql(
        "SELECT COUNT(*), AVG(score) FROM PREDICT(model='risk', data=patients) "
        "AS p WHERE score >= :t"
    )
    # ...or the fluent builder — same unified IR, same fingerprint:
    q = (db.table("patients").predict("risk").where("score >= :t")
         .select("COUNT(*)", "AVG(score)"))

    prep = q.prepare(transform="dnn", params={"t": 0.6})  # or "sql"; default "none"
    prep = q.prepare(strategy=fitted, verify="strict")  # learned runtime, checked
    print(prep.explain())        # logical -> physical -> stage graph
    out = prep()                 # one-shot execution, numpy columns out
    prep.bind(t=0.9)             # re-bind: same plan, no new compile
    out = prep(batch)            # a batch replaces the fact table's rows
    prep.serve()                 # bucketed, micro-batched, captured serving
    req = prep.submit(batch)     # ...then db.flush(), or a pump
    db.cache_stats()             # plan-cache, capture and server accounting
    db.models.publish("risk", pipe2)   # v2 staged and warmed on served routes
    db.models.cutover("risk", 2)       # atomic swap; shadow/split/rollback too

``:param`` placeholders lower to canonical ``Param`` slots that hash by name,
so a prepared plan re-binds thresholds without re-optimizing, re-compiling,
or changing its fingerprint. The session uploads its tables to its device
once, at :func:`connect`; a call uploads only the ``batch`` it is given.

A runtime-selection ``strategy`` (:mod:`repro_torch.core.strategies`)
picks each predict node's runtime from its pipeline's statistics where no
``transform`` is forced; ``verify`` (or ``RAVEN_VERIFY``) checks every plan
statically (:mod:`repro_torch.analysis.verifier`). ``cache_dir`` installs
an :class:`~repro_torch.exec.artifact_store.ArtifactStore` (warm starts
across processes, the registry's journal and ``db.recover()``), and
``ConnectOptions(faults=..., rollback=...)`` a fault plan and the policy
the registry's rollback checks enforce.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional, Union

import numpy as np

from repro_torch.core.ir import PredictionQuery, TableStats, format_logical_plan
from repro_torch.core.optimizer import (
    OptimizationReport,
    OptimizerOptions,
    RavenOptimizer,
    format_physical_plan,
)
from repro_torch.device import resolve_device
from repro_torch.errors import RavenError, RecoveryError, UnknownTableError, check_params
from repro_torch.exec.faults import get_fault_plan, set_fault_plan
from repro_torch.options import ConnectOptions, ServeOptions
from repro_torch.relational.engine import (
    PLAN_CACHE_STATS,
    PhysicalPlan,
    Scan,
    compile_plan,
    get_artifact_store,
    set_artifact_store,
    upload_database,
    walk_plan,
)
from repro_torch.relational.expr import Const, Expr, Param
from repro_torch.serve.query_server import PredictionQueryServer, QueryRequest
from repro_torch.serve.registry import ModelRegistry
from repro_torch.sql.parser import (
    QuerySpec,
    build_prediction_query,
    canonical_op,
    parse_condition,
    parse_select_items,
    parse_spec,
)


def connect(
    tables: dict[str, dict[str, np.ndarray]],
    stats: Union[str, dict[str, TableStats], None] = "auto",
    *,
    partition_cols: Optional[dict[str, str]] = None,
    strategy=None,
    options: Union[ConnectOptions, OptimizerOptions, None] = None,
    cache_dir: Optional[str] = None,
    cache_max_bytes: Optional[int] = None,
    verify: Union[str, bool, None] = None,
    device=None,
) -> "Session":
    """Open a session over a database of named column-dict tables.

    ``stats="auto"`` computes :class:`TableStats` for every table once (with
    optional per-table partition columns for the data-induced rule); pass a
    dict to supply stats yourself, or ``None`` to skip statistics entirely.
    ``options`` is a :class:`ConnectOptions` bundle or a bare
    :class:`OptimizerOptions` (the session's optimizer defaults, which
    :meth:`Query.prepare` can override per query). ``strategy`` is the
    session's runtime-selection strategy (a fitted
    :class:`~repro_torch.core.strategies.RuleBasedStrategy`,
    ``ClassificationStrategy`` or ``RegressionStrategy``): with no
    ``transform`` forced, it picks each predict node's runtime from the
    pipeline's statistics. ``verify`` sets the session-wide
    plan-verification mode: ``"off"``, ``"warn"`` or ``"strict"`` (``True``
    is strict), or None for ``RAVEN_VERIFY`` (default off). ``device`` is
    where the tables live and queries run: the card unless the caller
    passes ``device="cpu"``.

    ``cache_dir`` enables **warm starts across processes**: an
    :class:`~repro_torch.exec.artifact_store.ArtifactStore` rooted there
    persists optimizer output per query fingerprint (``prepare()`` skips
    re-optimization when the query, statistics and model weights match) and
    the structure of every bucket each pure stage served (``serve()``
    captures the graphs of all buckets found on disk at registration, so a
    fresh process serves them with no capture on the request path).
    Entries are keyed on content fingerprints and checked against a header
    (store, torch and CUDA versions, the device's capability, the kernels'
    sources), so a stale or corrupted cache falls back to live work, never
    to wrong results. The store is installed process-wide; the most recent
    ``connect`` wins. ``cache_max_bytes`` bounds the directory by size. The
    bundle's ``faults`` installs a :class:`~repro_torch.exec.faults.FaultPlan`
    process-wide for the session's lifetime, and ``rollback`` is the
    :class:`~repro_torch.exec.faults.RollbackPolicy` that
    ``db.models.check_rollback`` and its guards enforce.
    """
    return Session(
        tables, stats, partition_cols=partition_cols, strategy=strategy,
        options=options, cache_dir=cache_dir, cache_max_bytes=cache_max_bytes,
        verify=verify, device=device,
    )


class Session:
    """Owns the database (on its device), statistics, model registry,
    serving layer and artifact store."""

    def __init__(
        self,
        tables: dict[str, dict[str, np.ndarray]],
        stats: Union[str, dict[str, TableStats], None] = "auto",
        *,
        partition_cols: Optional[dict[str, str]] = None,
        strategy=None,
        options: Union[ConnectOptions, OptimizerOptions, None] = None,
        cache_dir: Optional[str] = None,
        cache_max_bytes: Optional[int] = None,
        verify: Union[str, bool, None] = None,
        device=None,
    ):
        copts = ConnectOptions.resolve(
            options, partition_cols=partition_cols, strategy=strategy,
            cache_dir=cache_dir, cache_max_bytes=cache_max_bytes, verify=verify,
        )
        self.connect_options = copts
        opt_options = copts.optimizer
        if copts.verify is not None:
            from repro_torch.analysis.verifier import resolve_verify_mode

            opt_options = dataclasses.replace(
                opt_options or OptimizerOptions(),
                verify=resolve_verify_mode(copts.verify),
            )
        self.strategy = copts.strategy
        self.options = opt_options
        self.device = resolve_device(device)
        self.tables = {
            t: {c: np.asarray(v) for c, v in cols.items()}
            for t, cols in tables.items()
        }
        if stats == "auto":
            parts = copts.partition_cols or {}
            self.stats = {
                t: TableStats.of(cols, partition_col=parts.get(t))
                for t, cols in self.tables.items()
            }
        elif stats is None:
            self.stats = {}
        elif isinstance(stats, dict):
            self.stats = dict(stats)
        else:
            raise RavenError(
                f"stats must be 'auto', a dict, or None — got {stats!r}"
            )
        self.models = ModelRegistry(self)
        # the tables on the session's device, once: every call runs on these
        self.database = upload_database(self.tables, self.device)
        self.artifact_store = None
        if copts.cache_dir is not None:
            from repro_torch.exec.artifact_store import ArtifactStore

            self.artifact_store = ArtifactStore(
                copts.cache_dir, max_bytes=copts.cache_max_bytes, device=self.device
            )
        # the most recent connect wins — including a cache-less connect,
        # which must *clear* a previous session's store rather than let it
        # keep intercepting (and writing to) every later specialization
        set_artifact_store(self.artifact_store)
        # a session-supplied FaultPlan is installed process-wide for its
        # lifetime (same most-recent-wins contract as the artifact store);
        # without one, the RAVEN_FAULTS env plan (if any) stays in effect
        self._fault_plan = copts.faults
        if copts.faults is not None:
            set_fault_plan(copts.faults)
        self._server: Optional[PredictionQueryServer] = None
        self._names = itertools.count()

    # -- registration --------------------------------------------------------

    def register_model(self, name: str, pipe_or_path):
        """Thin alias for :meth:`ModelRegistry.publish` (returns the
        pipeline)."""
        return self.models.publish(name, pipe_or_path).pipeline

    # -- query construction --------------------------------------------------

    def sql(self, text: str) -> "Query":
        """Parse PREDICT-statement SQL into a session-bound :class:`Query`."""
        q = Query(self, parse_spec(text))
        _ = q.ir  # build eagerly: unknown models/tables/columns fail here
        return q

    def table(self, name: str) -> "QueryBuilder":
        """Start a fluent query over ``name`` (the fact table)."""
        if name not in self.tables:
            raise UnknownTableError(
                f"unknown table '{name}' — known tables: {sorted(self.tables)}"
            )
        return QueryBuilder(self, QuerySpec(base=name))

    # -- serving -------------------------------------------------------------

    @property
    def server(self) -> PredictionQueryServer:
        """The session-owned :class:`PredictionQueryServer` (created lazily,
        on the session's device)."""
        if self._server is None:
            self._server = PredictionQueryServer(
                strategy=self.strategy, options=self.options, device=self.device
            )
        return self._server

    def flush(self) -> list[QueryRequest]:
        """Execute everything submitted to served queries (micro-batched)."""
        return self._server.flush() if self._server is not None else []

    def _next_name(self) -> str:
        return f"q{next(self._names)}"

    # -- crash recovery ------------------------------------------------------

    def recover(self) -> dict:
        """Rebuild the model registry + serving topology from the journal.

        A session opened with ``cache_dir`` journals every registry
        lifecycle mutation (publish/shadow/split/cutover/retire/rollback and
        route registrations) through the artifact store, keyed on the
        session's table-schema fingerprint. After a crash, a fresh session
        over the same tables and cache dir calls ``recover()`` to restore
        published versions (with their recorded histories), live/shadow/
        split pointers, the rollback log, and every served route — re-served
        under its original name and options, its observed bucket ladder
        restored and warm-replayed (the stored bucket structures captured at
        registration), so the recovered server answers previously seen
        shapes with no new capture on the request path. Returns
        ``{"recovered": False}`` when no journal exists, else counts
        (models/versions/routes restored, routes skipped)."""
        if self.artifact_store is None:
            raise RecoveryError(
                "recover() needs an artifact store — connect with "
                "ConnectOptions(cache_dir=...)"
            )
        state = self.artifact_store.load_registry(self._journal_key())
        if state is None:
            return {"recovered": False}
        counts = self.models._restore(state)
        counts["recovered"] = True
        return counts

    def _journal_key(self) -> str:
        """The registry journal's store key: a fingerprint of the session's
        table schemas (names, columns, dtypes — not row contents), so a
        restarted server over the same database finds its journal while a
        schema change quietly orphans the stale one."""
        from repro_torch.core.fingerprint import fingerprint

        return fingerprint(
            "registry-journal",
            tuple(
                (t, tuple((c, str(v.dtype)) for c, v in sorted(cols.items())))
                for t, cols in sorted(self.tables.items())
            ),
        )

    # -- accounting ----------------------------------------------------------

    def cache_stats(self) -> dict:
        """Compiled-plan cache and serving accounting, in one snapshot: the
        engine's :class:`~repro_torch.relational.engine.CacheStats`
        (``hits``/``misses``/``traces``, per-stage ``stage_traces``, graph
        ``replays`` and ``capture_input_copies``, the ``graphs`` held and
        their ``graph_bytes``), the session server's counters under
        ``"server"`` (with the scheduler's queue gauges, the pipelined
        executor's under ``"pipeline"``, ``recompiles``, ``breaker_trips``
        and per-route version state under ``"routes"``), the artifact
        store's :class:`~repro_torch.exec.artifact_store.StoreStats` under
        ``"artifact_store"`` when the session has one (with ``disk_hits``/
        ``disk_misses`` at the top level), and the model registry's under
        ``"models"``."""
        out = PLAN_CACHE_STATS.snapshot()
        if self._server is not None:
            out["server"] = self._server.stats_snapshot()
            out["server"]["recompiles"] = self._server.recompiles()
        if self.artifact_store is not None:
            out["artifact_store"] = self.artifact_store.stats.snapshot()
        out["models"] = self.models.snapshot()
        return out

    def close(self) -> None:
        """Stop any running rollback guards and the server's pump (it
        drains pending requests first), release its boundary pool, flush
        the artifact store's background writer, and uninstall this
        session's artifact store and fault plan (if still the active
        ones)."""
        self.models.close()  # stop rollback guards before the pump drains
        if self._server is not None:
            self._server.shutdown()
        if self.artifact_store is not None:
            self.artifact_store.close()  # flush writes + stop the writer
            if get_artifact_store() is self.artifact_store:
                set_artifact_store(None)
        if self._fault_plan is not None and get_fault_plan() is self._fault_plan:
            set_fault_plan(None)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Query:
    """A prediction query bound to a session (unified IR + parameters)."""

    def __init__(self, session: Session, spec: QuerySpec):
        self._session = session
        self._spec = spec
        self._ir: Optional[PredictionQuery] = None

    @property
    def session(self) -> Session:
        return self._session

    @property
    def spec(self) -> QuerySpec:
        return self._spec

    @property
    def ir(self) -> PredictionQuery:
        """The unified IR (built once; SQL text and the fluent builder lower
        through the same spec -> IR path, so equal queries hash equal)."""
        if self._ir is None:
            self._ir = build_prediction_query(
                self._spec, self._session.models, self._session.tables,
                self._session.stats,
            )
        return self._ir

    def fingerprint(self) -> str:
        return self.ir.fingerprint()

    def param_names(self) -> frozenset[str]:
        return frozenset(self.ir.params())

    def prepare(
        self,
        *,
        strategy=None,
        transform: Optional[str] = None,
        params: Optional[dict[str, Any]] = None,
        options: Optional[OptimizerOptions] = None,
        verify: Union[str, bool, None] = None,
    ) -> "PreparedQuery":
        """Run the optimizer once and compile; returns a reusable handle.

        ``transform`` forces a runtime: ``"dnn"`` (the tensor runtime on the
        device; a pipeline with ops it cannot lower is split around them,
        ``TensorOp → MLUdf → TensorOp``), ``"sql"`` (the pipeline compiled
        into relational expressions, run with the query's operators) or
        ``"none"`` (the interpreted ML runtime on the host, behind one
        MLUdf); ``None`` leaves the choice to ``strategy`` (this query's,
        else the session's), which picks from the pipeline's statistics,
        and without one resolves to ``"none"``. ``options`` overrides the
        full optimizer configuration. All ``:param`` placeholders must be
        bound via ``params`` (re-bindable later with
        :meth:`PreparedQuery.bind`).

        ``verify`` overrides the session's plan-verification mode for this
        prepare only — ``True`` (= ``"strict"``) raises
        :class:`~repro_torch.errors.PlanVerificationError` on any verifier
        violation, ``"warn"`` warns, ``"off"`` disables. The mode does not
        change the produced plan, its fingerprint, or any cache key.

        When the session has an artifact store (``connect(cache_dir=...)``),
        the optimizer's output is persisted per query fingerprint — a fresh
        process re-preparing the same query over the same statistics and
        model weights loads the optimized plan from disk instead of
        re-running the optimizer (plans holding a ``TensorOp`` program are
        not persisted: they optimize again)."""
        opts = options or self._session.options or OptimizerOptions()
        if transform is not None:
            opts = dataclasses.replace(opts, transform=transform)
        if verify is not None:
            from repro_torch.analysis.verifier import resolve_verify_mode

            opts = dataclasses.replace(opts, verify=resolve_verify_mode(verify))
        strat = strategy if strategy is not None else self._session.strategy
        declared = self.param_names()
        bound = dict(params or {})
        check_params(declared, bound, context="query")
        plan, report = self._optimize(opts, strat)
        return PreparedQuery(self, plan, report, opts, strat, bound)

    def _optimize(self, opts: OptimizerOptions, strat):
        """Run the optimizer, through the disk tier when one is active."""
        from repro_torch.core.fingerprint import fingerprint

        store = self._session.artifact_store
        key: Optional[str] = None
        if store is not None:
            # the optimizer is a pure function of (IR plan incl. model
            # weights, stats, options, strategy); a key hashing any component
            # by identity is not valid in another process, so skip the store.
            # the verify mode only decides whether the plan is *checked*,
            # never what plan comes out, so it must not fork cache entries
            pins: list = []
            key = fingerprint(
                self.ir.plan, self.ir.stats,
                dataclasses.replace(opts, verify=None), strat, pins=pins,
            )
            if pins:
                store.stats.skipped += 1
                key = None
        if key is not None:
            hit = store.load_plan(key)
            if hit is not None:
                PLAN_CACHE_STATS.disk_hits += 1
                return hit
            PLAN_CACHE_STATS.disk_misses += 1
        plan, report = RavenOptimizer(strategy=strat, options=opts).optimize(self.ir)
        if key is not None:
            store.save_plan(key, plan, report)
        return plan, report


class QueryBuilder(Query):
    """Fluent construction of the same :class:`QuerySpec` the SQL parser
    produces (so builder and SQL queries are fingerprint-identical)."""

    def _with(self, **changes) -> "QueryBuilder":
        return QueryBuilder(
            self._session, dataclasses.replace(self._spec, **changes)
        )

    def join(
        self, dim_table: str, on: Union[str, tuple[str, str]]
    ) -> "QueryBuilder":
        """FK-join a dimension table; ``on`` is a shared key name or a
        ``(fact_col, dim_col)`` pair."""
        a, b = (on, on) if isinstance(on, str) else on
        return self._with(joins=[*self._spec.joins, (dim_table, a, b)])

    def predict(self, model: str) -> "QueryBuilder":
        """Apply a registered model (its outputs become columns
        ``score``/``pred``)."""
        return self._with(model=model)

    def where(
        self, cond: str, op: Optional[str] = None, value: Any = None
    ) -> "QueryBuilder":
        """Add one conjunct: ``where("score >= :t")`` or
        ``where("score", ">=", 0.6)``."""
        if op is None:
            pred = parse_condition(cond)
        else:
            if isinstance(value, Expr):
                v = value
            elif isinstance(value, str):
                # same lowering as the SQL parser: ':name' is a parameter,
                # any other string a literal
                v = Param(value[1:]) if value.startswith(":") else Const(value)
            else:
                v = Const(float(value))
            pred = (cond, canonical_op(op), v)
        return self._with(preds=[*self._spec.preds, pred])

    def select(self, *items: str) -> "QueryBuilder":
        """Set the select list, e.g. ``select("COUNT(*)", "AVG(score)")``;
        the default (no select) is ``*``."""
        parsed = [it for s in items for it in parse_select_items(s)]
        return self._with(items=parsed)


class PreparedQuery:
    """An optimized + compiled prediction query.

    ``plan``/``report`` are the optimizer's output; ``compiled`` the cached
    stage graph. Call it for one-shot execution, :meth:`bind` to re-bind
    ``:param`` values without re-optimizing or re-compiling."""

    def __init__(
        self,
        query: Query,
        plan: PhysicalPlan,
        report: OptimizationReport,
        options: OptimizerOptions,
        strategy,
        params: dict[str, Any],
    ):
        self.query = query
        self.plan = plan
        self.report = report
        self.options = options
        self.strategy = strategy
        self.params = dict(params)
        self.compiled = compile_plan(plan)
        self._verify_compiled()
        self.param_names = query.param_names()
        self._serve_name: Optional[str] = None
        self._serve_token: Optional[str] = None
        self._serve_options: Optional[ServeOptions] = None
        self._server: Optional[PredictionQueryServer] = None

    def _verify_compiled(self) -> None:
        """Static verification of the lowered stage graph (mode permitting),
        after ``compile_plan``: the graph checks, and the abstract run on
        the session's device against its uploaded tables (the plan's tensor
        programs are moved there, where its calls run them).
        Verified lines land in ``report.verification`` (rendered by
        :meth:`explain`); strict mode raises
        :class:`~repro_torch.errors.PlanVerificationError`.
        """
        from repro_torch.analysis.verifier import resolve_verify_mode, verify_graph

        mode = resolve_verify_mode(self.options.verify)
        if mode == "off":
            return
        lines = verify_graph(self.compiled.graph, self.query.session.database,
                             mode=mode, context="prepare (stage graph)")
        ver = self.report.verification
        ver += [ln for ln in lines if ln not in ver]

    @property
    def fingerprint(self) -> str:
        """Content hash of the physical plan (the compiled-plan cache key)."""
        return self.compiled.fingerprint

    @property
    def name(self) -> Optional[str]:
        """The name this query is served under (None until :meth:`serve`)."""
        return self._serve_name

    # -- parameter binding ---------------------------------------------------

    def bind(self, _params: Optional[dict[str, Any]] = None, **kw) -> "PreparedQuery":
        """Re-bind ``:param`` values: ``prep.bind(t=0.9)``. The optimized
        plan, its fingerprint and the compiled stages are reused as they
        are: the value rides in as a runtime input."""
        new = {**(_params or {}), **kw}
        check_params(self.param_names, new, require_all=False, context="query")
        self.params.update(new)
        if self._server is not None:
            self._server.rebind(self._serve_name, new)
        return self

    # -- one-shot execution --------------------------------------------------

    def __call__(
        self, batch: Optional[dict[str, np.ndarray]] = None
    ) -> dict[str, np.ndarray]:
        """Execute once against the session's tables on its device
        (``batch`` replaces the fact table's rows, and is the only upload)
        and return compacted numpy columns."""
        session = self.query.session
        db = session.database
        if batch is not None:
            fact = self._fact_table()
            scan_cols = {
                c for s in walk_plan(self.plan)
                if isinstance(s, Scan) and s.table == fact
                for c in s.columns
            }
            missing = sorted(scan_cols - set(batch))
            if missing:
                raise RavenError(
                    f"batch for fact table '{fact}' is missing columns "
                    f"{missing}"
                )
            db = db.replace(fact, batch)
        res = self.compiled.run(
            db, params=self.params if self.param_names else None,
            device=session.device,
        )
        return res.table.to_numpy(compact=True)

    def _fact_table(self) -> str:
        base = self.query.spec.base
        if base is not None:
            return base
        return next(s.table for s in walk_plan(self.plan) if isinstance(s, Scan))

    # -- serving -------------------------------------------------------------

    def serve(
        self,
        name: Optional[str] = None,
        server: Optional[PredictionQueryServer] = None,
        *,
        options: Optional[ServeOptions] = None,
        max_latency_ms: Optional[float] = None,
        max_pending: Optional[int] = None,
        max_coalesce: Optional[int] = None,
    ) -> "PreparedQuery":
        """Register into the session-owned server (bucketed, coalesced,
        captured hot path): afterwards ``prep.submit(batch)`` enqueues.

        ``options`` is the typed surface (:class:`ServeOptions`); the loose
        keywords keep working through a :class:`DeprecationWarning` shim,
        and a keyword conflicting with the bundle raises. With
        ``max_latency_ms`` a background pump flushes automatically once this
        query's oldest pending request has waited that long (results arrive
        via ``request.wait()``); without it the caller drives
        ``db.flush()``. ``max_pending`` bounds this query's queue (a submit
        against a full queue blocks or raises
        :class:`~repro_torch.errors.ServerOverloadedError`), ``max_coalesce``
        caps the rows one dispatched group may coalesce. The server reads
        the session's tables where they lie on its device; each group
        uploads only its padded batch.

        Serving also registers this query's route with the session's
        :class:`~repro_torch.serve.registry.ModelRegistry`: later
        ``db.models.publish()`` calls for the referenced model stage their
        new version onto this route, and ``shadow``/``split``/``cutover``
        act on it.
        """
        sopts = ServeOptions.resolve(
            options, max_latency_ms=max_latency_ms,
            max_pending=max_pending, max_coalesce=max_coalesce,
        )
        self._serve_options = sopts
        session = self.query.session
        srv = server if server is not None else session.server
        self._serve_name = name or session._next_name()
        model_ref = self.query.spec.model
        version_label = "v1"
        if model_ref is not None:
            try:
                version_label = session.models.resolve(model_ref).label
            except RavenError:
                pass  # model outside the registry (e.g. a bare test server)
        reg = srv.register(
            self._serve_name, self.query.ir, session.database,
            fact_table=self._fact_table(),
            optimized=(self.plan, self.report),
            params=self.params,
            max_latency_ms=sopts.max_latency_ms,
            max_pending=sopts.max_pending,
            max_coalesce=sopts.max_coalesce,
            version_label=version_label,
            donate=sopts.donate,
            retry=sopts.retry,
            breaker_threshold=sopts.breaker_threshold,
        )
        self._serve_token = reg.token
        self._server = srv
        if model_ref is not None:
            session.models._track_route(model_ref, self._serve_name, self, srv)
        if sopts.max_latency_ms is not None:
            srv.start_pump(sopts.max_latency_ms)
        return self

    def submit(
        self,
        columns: dict[str, np.ndarray],
        *,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> QueryRequest:
        """Enqueue one fact-row batch (requires :meth:`serve` first); results
        land on the returned request after ``db.flush()`` — or, when the
        query is served with a latency target, after the pump's next flush
        (``request.wait()``). Submitting through a handle whose serve name
        was since re-registered raises
        :class:`~repro_torch.errors.StaleQueryError`; a submit against a
        full bounded queue blocks up to ``timeout`` seconds or
        (``block=False``) raises
        :class:`~repro_torch.errors.ServerOverloadedError`."""
        if self._server is None:
            raise RavenError("query is not served — call .serve() before .submit()")
        return self._server.submit(
            self._serve_name, columns, expect_token=self._serve_token,
            block=block, timeout=timeout,
        )

    # -- introspection -------------------------------------------------------

    def explain(self) -> str:
        """Pretty-print the logical -> physical story: the query as written,
        the optimized plan (chosen runtimes, pushed projections, rewritten
        thresholds), the optimizer's notes and the stage graph."""
        session = self.query.session
        lines = [f"PreparedQuery  fingerprint={self.fingerprint[:16]}…"]
        if self.param_names:
            binds = ", ".join(
                f":{k} = {self.params[k]!r}" if k in self.params else f":{k} (unbound)"
                for k in sorted(self.param_names)
            )
            lines.append(f"params: {binds}")
        lines.append("-- resolved options " + "-" * 35)
        lines.append(f"connect: {session.connect_options.describe()}")
        if self._serve_options is not None:
            lines.append(f"serve:   {self._serve_options.describe()}")
        lines.append(f"device:  {session.device}")
        model_ref = self.query.spec.model
        if model_ref is not None:
            name = str(model_ref).partition("@")[0]
            rec = session.models.snapshot().get(name)
            if rec is not None:
                lines.append("-- model lifecycle " + "-" * 36)
                extra = ""
                if rec["shadow"] is not None:
                    extra += f", shadow=v{rec['shadow']}"
                if rec["split"]:
                    extra += f", split={rec['split']}"
                lines.append(f"{name}: live=v{rec['live']}{extra}")
                for r in rec["rollbacks"]:
                    lines.append(
                        f"* rolled back v{r['from']} -> v{r['to']}: {r['reason']}"
                    )
        lines.append("-- logical plan (as written) " + "-" * 26)
        lines.append(format_logical_plan(self.query.ir.plan))
        lines.append("-- physical plan (optimized) " + "-" * 26)
        lines.append(format_physical_plan(self.plan))
        lines.append("-- chosen runtimes " + "-" * 36)
        for i, t in sorted(self.report.transforms.items()):
            lines.append(f"predict[{i}] -> {t}")
        if self.report.placement:
            lines.append("-- runtime placement (per pipeline op) " + "-" * 17)
            for i, nodes in enumerate(self.report.placement):
                runtimes = {r for _, r in nodes}
                if any("/" in r for r in runtimes):
                    # split lowering: every op with its segment's runtime
                    lines.append(f"predict[{i}]: split across runtimes")
                    for label, r in nodes:
                        lines.append(f"  {r:<16} {label}")
                elif len(runtimes) == 1:
                    lines.append(f"predict[{i}]: all {len(nodes)} ops on {runtimes.pop()}")
                else:
                    for label, r in nodes:
                        lines.append(f"  {r:<16} {label}")
        if self.report.relational:
            lines.append("-- runtime placement (relational ops) " + "-" * 18)
            for label, r in self.report.relational:
                lines.append(f"  {label}")
                lines.append(f"    -> {r}")
        scans = [s for s in walk_plan(self.plan) if isinstance(s, Scan)]
        if scans:
            lines.append("-- pushed projections " + "-" * 33)
            for s in scans:
                total = len(session.tables.get(s.table, s.columns))
                lines.append(
                    f"{s.table}: reads {len(s.columns)}/{total} columns"
                )
        if self.report.notes:
            lines.append("-- optimizer notes " + "-" * 36)
            for n in self.report.notes:
                lines.append(f"* {n}")
        if self.report.verification:
            lines.append("-- plan verification " + "-" * 34)
            for v in self.report.verification:
                lines.append(f"* {v}")
        graph = self.compiled.graph
        summary = "1 pure stage" if graph.is_pure else (
            f"{len(graph.stages)} stages, {graph.n_host_boundaries} host boundary(ies)"
        )
        lines.append(f"-- stage graph: {summary} " + "-" * 20)
        for st in graph.stages:
            lines.append(f"[{st.index}] {st.kind}: {st.label}  "
                         f"fingerprint={st.fingerprint[:12]}…")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (
            f"PreparedQuery(fingerprint={self.fingerprint[:12]}…, "
            f"params={self.params})"
        )
