"""Serving layer for prediction queries: optimize once, execute hot.

The port of the reference's ``PredictionQueryServer`` on the card. A
prediction query is optimized once and then served at high request rates:

  * ``register`` runs the :class:`RavenOptimizer` once per (query, stats)
    — structurally identical registrations share the optimized physical plan
    via the canonical query fingerprint — and compiles the plan into a
    reusable stage graph through the engine's fingerprint-keyed plan cache.
    The registered tables go to the card once.
  * Incoming batches are padded to a power-of-two row bucket with a validity
    mask at **every pure-stage boundary**: query entry *and* each MLUdf host
    boundary's exit, so post-UDF stages stay on the CUDA graphs captured for
    their buckets (:mod:`repro_torch.exec.capture`): one capture per (stage,
    bucket), and none on a warm bucket.
  * ``submit``/``flush`` micro-batch: pending requests against the same query
    coalesce into one padded execution. Pure row-aligned plans are sliced
    back by position; host-boundary and aggregate plans thread per-request
    *segment ids* through the graph (compaction-proof) and split on them.
  * Request scheduling is a :class:`~repro_torch.exec.scheduler.Scheduler`:
    every query gets its own bounded queue (``max_pending`` backpressure
    raising :class:`~repro_torch.errors.ServerOverloadedError`), its own
    latency target, and a coalesce-width cap; the background pump flushes
    queues earliest-deadline-first.
  * Dispatched groups execute through the **pipelined**
    :class:`~repro_torch.exec.pipeline.PipelineExecutor`: pure stages are
    enqueued on the card and MLUdf boundaries run on a boundary thread pool,
    so one group's host work overlaps another group's device work
    (``pipelined=False`` restores the serial stage-at-a-time runner for A/B
    measurement).

Without a pump the server stays synchronous — ``submit`` enqueues, ``flush``
drains — so tests and examples can drive it deterministically.

Each served name holds one version of its query. The reference's model
lifecycle on top of that (``stage_version``, ``warm_version``,
``set_shadow``, ``set_split``, ``cutover``, ``retire_version``, the circuit
breaker) raises ``NotImplementedError`` naming ROADMAP.md Queue 1 item 7.
Under a verify mode other than ``off`` (the optimizer options' ``verify``,
else ``RAVEN_VERIFY``), ``register`` re-verifies the stage graph it will
serve, abstract execution included, against the registered tables.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.analysis.runtime import asserts_enabled, runtime_assert
from repro_torch.analysis.verifier import resolve_verify_mode, verify_graph
from repro_torch.core.fingerprint import fingerprint
from repro_torch.core.ir import PredictionQuery
from repro_torch.core.optimizer import OptimizationReport, OptimizerOptions, RavenOptimizer
from repro_torch.device import resolve_device
from repro_torch.errors import (
    RavenError,
    RequestTimeoutError,
    StaleQueryError,
    TransientError,
    UnknownQueryError,
    check_params,
)
from repro_torch.exec.faults import RetryPolicy, get_fault_plan, maybe_inject
from repro_torch.exec.pipeline import PipelineExecutor
from repro_torch.exec.scheduler import Scheduler
from repro_torch.relational.engine import (
    CompiledPlan,
    Database,
    PhysicalPlan,
    Scan,
    compile_plan,
    plan_params,
    upload_database,
    walk_plan,
)

LIFECYCLE_NOT_PORTED = (
    "the model-version lifecycle (staged versions, warm replay, shadow, "
    "split, cutover, retirement and the circuit breaker) is not ported yet: "
    "ROADMAP.md Queue 1 item 7, persistence and lifecycle"
)


def row_bucket(n: int, min_bucket: int = 64) -> int:
    """Smallest power-of-two bucket holding ``n`` rows (≥ ``min_bucket``)."""
    b = max(int(min_bucket), 1)
    while b < n:
        b <<= 1
    return b


def canonical_dtype(dt: np.dtype) -> np.dtype:
    """The dtype a column actually runs under on the card (64-bit types
    demoted, as the upload demotes them).

    Registered schemas and submitted batches are normalized to this *at
    submit time*, on the submitter's thread: a float64 → float32 cast per
    group on the scheduler thread would serialize the whole server behind
    it. After normalization the serving path's host→device transfers are
    plain copies.
    """
    dt = np.dtype(dt)
    if dt.kind == "f" and dt.itemsize > 4:
        return np.dtype(np.float32)
    if dt.kind in "iu" and dt.itemsize > 4:
        return np.dtype(np.int32)
    return dt


@dataclass
class QueryRequest:
    """One submitted batch; ``result`` is filled by ``flush`` (or the pump)."""

    rid: int
    query: str
    columns: dict[str, np.ndarray]
    n_rows: int
    result: Optional[dict[str, np.ndarray]] = None
    done: bool = False
    error: Optional[BaseException] = None  # execution failure, re-raised by wait()
    t_submit: float = 0.0
    t_done: float = 0.0
    _event: threading.Event = field(
        default_factory=threading.Event, repr=False, compare=False
    )

    def wait(self, timeout: Optional[float] = None) -> dict[str, np.ndarray]:
        """Block until this request's result is ready (pump-driven serving)
        and return it; re-raises the execution error if its batch failed.

        An expired ``timeout`` raises the typed
        :class:`~repro_torch.errors.RequestTimeoutError`, so the caller can
        tell "the server never answered" from "the server answered with a
        failure" (typed errors re-raise as themselves; foreign exceptions
        are wrapped so the waiter always sees a
        :class:`~repro_torch.errors.RavenError`)."""
        if not self._event.wait(timeout):
            raise RequestTimeoutError(
                f"request {self.rid} for query '{self.query}' not served "
                f"within {timeout}s — is a pump running / was flush() called?"
            )
        if self.error is not None:
            if isinstance(self.error, RavenError):
                raise self.error
            raise RavenError(
                f"request {self.rid} for query '{self.query}' failed during "
                f"execution: {self.error}"
            ) from self.error
        return self.result

    @property
    def latency_s(self) -> float:
        """Submit-to-result wall time (0.0 until served)."""
        return (self.t_done - self.t_submit) if self.done else 0.0


@dataclass
class ServerStats:
    queries_registered: int = 0
    plan_cache_hits: int = 0    # optimizer runs avoided via query fingerprint
    plan_cache_misses: int = 0
    bucket_hits: int = 0        # executions landing on an already-seen
    bucket_misses: int = 0      # (query, schema, bucket) combination
    mid_bucket_hits: int = 0    # host-boundary exits landing on an already-
    mid_bucket_misses: int = 0  # seen (query, stage, bucket) combination
    batches_executed: int = 0
    requests_served: int = 0
    coalesced_requests: int = 0  # requests that shared a batch with others
    segmented_batches: int = 0   # coalesced executions split by segment ids
    pipelined_groups: int = 0    # groups dispatched through the async path
    flushes: int = 0             # dispatched request groups
    rows_in: int = 0
    rows_padded: int = 0

    def snapshot(self) -> dict[str, int]:
        return dict(self.__dict__)


@dataclass
class RegisteredQuery:
    name: str
    token: str  # unique per registration: the stale-handle guard key
    query_fingerprint: str
    plan: PhysicalPlan
    report: OptimizationReport
    compiled: CompiledPlan
    database: Database  # the registered tables, on the card once
    fact_table: str
    scan_columns: list[str]
    fact_dtypes: dict[str, np.dtype]
    has_aggregate: bool
    param_names: frozenset[str] = frozenset()
    params: dict[str, Any] = field(default_factory=dict)
    donate: bool = True  # padded entry buffers are single-use

    @property
    def recompiles(self) -> int:
        """Stage specializations of this query's compiled plan: captures on
        the card, new input structures on the CPU."""
        return self.compiled.traces

    @property
    def sliceable(self) -> bool:
        """Coalesced output rows stay 1:1 aligned with the input spine, so
        per-request results fall out of positional slicing — no segment ids
        needed. False once a host boundary (compaction) or an aggregate
        (folding) breaks the alignment."""
        return not self.compiled.graph.needs_segments


class PredictionQueryServer:
    def __init__(
        self,
        strategy=None,
        options: Optional[OptimizerOptions] = None,
        *,
        min_bucket: int = 64,
        max_bucket: int = 1 << 20,
        pipelined: bool = True,
        device=None,
    ):
        self.optimizer = RavenOptimizer(strategy=strategy, options=options)
        self.device = resolve_device(device)
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        # pipelined=False restores the serial stage-at-a-time group runner
        # (the A/B baseline)
        self.pipelined = pipelined
        self.stats = ServerStats()
        self.queries: dict[str, RegisteredQuery] = {}
        self.executor = PipelineExecutor(workers=2)
        self.scheduler = Scheduler(
            self._dispatch_group,
            default_coalesce=max_bucket,
            # terminal-failure delivery: when a group exhausts its retries
            # (or fails deterministically) every waiter gets the typed error
            fail=self._fail_group,
        )
        self._optimized: dict[str, tuple[PhysicalPlan, OptimizationReport]] = {}
        self._pins: list[Any] = []  # keeps identity-hashed objects alive
        self._seen_buckets: set[tuple[str, tuple, int]] = set()
        self._seen_mid_buckets: set[tuple[str, int, int]] = set()
        self._rid = itertools.count()
        self._reg_serial = itertools.count()
        self._lock = threading.Lock()  # guards stats/seen-bucket mutation

    # -- registration --------------------------------------------------------

    def register(
        self,
        name: str,
        query: PredictionQuery,
        database: dict,
        fact_table: Optional[str] = None,
        *,
        optimized: Optional[tuple[PhysicalPlan, OptimizationReport]] = None,
        params: Optional[dict[str, Any]] = None,
        max_latency_ms: Optional[float] = None,
        max_pending: Optional[int] = None,
        max_coalesce: Optional[int] = None,
        donate: bool = True,
        retry: Optional[RetryPolicy] = None,
        breaker_threshold: Optional[int] = None,
    ) -> RegisteredQuery:
        """Optimize + compile ``query`` and make it servable under ``name``.

        ``database`` supplies the dimension tables (uploaded to the card
        once; a session's uploaded database is used as it is) and the fact
        table's schema; serve-time batches replace the fact rows.
        ``optimized`` seeds the (plan, report) for a query the caller
        already optimized (the session front door's PreparedQuery path).
        ``params`` binds the query's ``:param`` placeholders; re-bind via
        :meth:`rebind` without touching the compiled plan.

        The scheduling knobs configure this query's scheduler queue:
        ``max_latency_ms`` its flush deadline (earliest-deadline-first across
        queries), ``max_pending`` its backpressure bound, ``max_coalesce``
        the most rows one dispatched group may take, ``retry`` the
        transient-failure :class:`~repro_torch.exec.faults.RetryPolicy`.
        ``donate=False`` keeps the padded entry buffers out of the donated
        set. Re-registering an existing name mints a new token — outstanding
        submit handles go stale. A ``breaker_threshold`` raises (ROADMAP
        item 7).
        """
        if breaker_threshold is not None:
            raise NotImplementedError(f"a circuit breaker: {LIFECYCLE_NOT_PORTED}")
        if optimized is not None:
            # externally optimized (the session's PreparedQuery path): key
            # on the supplied plan rather than seeding the (query, server
            # options) cache with a foreign plan
            plan, report = optimized
            qfp = fingerprint(query.plan, query.stats, "external", pins=self._pins)
        else:
            qfp = fingerprint(
                query.plan, query.stats, self.optimizer.options,
                self.optimizer.strategy, pins=self._pins,
            )
            cached = self._optimized.get(qfp)
            if cached is not None:
                with self._lock:
                    self.stats.plan_cache_hits += 1
                plan, report = cached
            else:
                with self._lock:
                    self.stats.plan_cache_misses += 1
                plan, report = self.optimizer.optimize(query)
                self._optimized[qfp] = (plan, report)
        compiled = compile_plan(plan)
        db = upload_database(database, self.device)
        verify_mode = resolve_verify_mode(self.optimizer.options.verify)
        if verify_mode != "off":
            # a plan optimized elsewhere skips the optimizer's differential
            # checks, so the server re-verifies the graph it will actually
            # serve — including abstract execution against the registered
            # tables (bucket polymorphism, dtype stability) on its device
            lines = verify_graph(compiled.graph, db, mode=verify_mode,
                                 context=f"register '{name}'")
            report.verification += [
                ln for ln in lines if ln not in report.verification
            ]
        param_names = frozenset(plan_params(plan))
        bound = dict(params or {})
        check_params(param_names, bound, context=f"query '{name}'")
        scans = [p for p in walk_plan(plan) if isinstance(p, Scan)]
        if fact_table is None:
            fact_table = scans[0].table
        if fact_table not in database:
            raise KeyError(f"fact table '{fact_table}' missing from database")
        scan_columns = [c for s in scans if s.table == fact_table for c in s.columns]
        reg = RegisteredQuery(
            name=name,
            # plan fingerprints are invariant under :param values
            # (rebinding must not recompile), so the handle guard is a
            # serial token per registration
            token=f"route#{next(self._reg_serial)}",
            query_fingerprint=qfp,
            plan=plan,
            report=report,
            compiled=compiled,
            database=db,
            fact_table=fact_table,
            scan_columns=scan_columns,
            # the full registered fact schema: submit normalizes every
            # provided fact column against it
            fact_dtypes={
                c: canonical_dtype(_dtype_of(v))
                for c, v in database[fact_table].items()
            },
            has_aggregate=compiled.graph.has_aggregate,
            param_names=param_names,
            params={k: float(v) for k, v in bound.items()},
            donate=donate,
        )
        with self._lock:
            self.queries[name] = reg
        self.scheduler.configure(
            name, max_latency_ms=max_latency_ms, max_pending=max_pending,
            max_coalesce=max_coalesce, retry=retry,
        )
        with self._lock:
            self.stats.queries_registered += 1
        return reg

    def rebind(self, name: str, params: dict[str, Any]) -> RegisteredQuery:
        """Re-bind ``:param`` values for a registered query: the plan, its
        graphs and the shape buckets are untouched — the new values flow
        into the next execution as runtime inputs (nothing captured)."""
        reg = self._registered(name)
        check_params(
            reg.param_names, params, require_all=False, context=f"query '{name}'"
        )
        reg.params.update({k: float(v) for k, v in params.items()})
        return reg

    # -- the model-version lifecycle: not ported ------------------------------

    def stage_version(self, *args, **kwargs):
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    def warm_version(self, *args, **kwargs):
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    def set_shadow(self, *args, **kwargs):
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    def set_split(self, *args, **kwargs):
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    def cutover(self, *args, **kwargs):
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    def retire_version(self, *args, **kwargs):
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    def _registered(self, name: str) -> RegisteredQuery:
        reg = self.queries.get(name)
        if reg is None:
            raise UnknownQueryError(
                f"no query registered under '{name}' — registered: "
                f"{sorted(self.queries) or '(none)'}"
            )
        return reg

    # -- the pump ------------------------------------------------------------

    def start_pump(self, max_latency_ms: float = 5.0) -> Scheduler:
        """Start (or retune) the background pump thread: submitted requests
        flush automatically, each queue by its own deadline (queues without
        an explicit ``max_latency_ms`` use the scheduler default, which the
        tightest ``start_pump`` call wins)."""
        sch = self.scheduler
        if sch.running:
            sch.default_latency_ms = min(sch.default_latency_ms, float(max_latency_ms))
        else:
            sch.default_latency_ms = float(max_latency_ms)
            sch.start()
        return sch

    def stop_pump(self) -> None:
        if self.scheduler.running:
            self.scheduler.stop()  # drains pending requests

    @property
    def pump(self) -> Optional[Scheduler]:
        """The scheduler, when its pump thread is running (else None)."""
        return self.scheduler if self.scheduler.running else None

    def shutdown(self) -> None:
        """Stop the pump (draining) and release the boundary pool."""
        self.stop_pump()
        self.executor.shutdown()

    # -- request lifecycle ---------------------------------------------------

    def submit(
        self,
        name: str,
        columns: dict[str, np.ndarray],
        *,
        expect_token: Optional[str] = None,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> QueryRequest:
        """Enqueue one batch of fact rows for ``name``; run via ``flush`` (or
        the pump). ``expect_token`` guards against serving through a stale
        handle: if ``name`` has been re-registered since the caller's
        ``serve()``, the submit is rejected instead of silently answering
        the wrong query.

        When the query was registered with ``max_pending`` and its queue is
        full, a blocking submit waits (up to ``timeout`` seconds) for the
        scheduler to free space; ``block=False`` — or an expired timeout —
        raises :class:`~repro_torch.errors.ServerOverloadedError` instead.
        """
        reg = self._registered(name)
        if expect_token is not None and expect_token != reg.token:
            raise StaleQueryError(
                f"query '{name}' was re-registered since this handle served "
                f"it (registration {reg.token} != handle's "
                f"{expect_token}) — re-serve the prepared query to refresh "
                f"the handle"
            )
        missing = [c for c in reg.scan_columns if c not in columns]
        if missing:
            raise KeyError(f"batch for '{name}' missing columns {sorted(missing)}")
        # normalize dtypes to the registered fact schema so every
        # bucket-sized batch maps onto the same captured graph
        cols = {
            c: np.asarray(v).astype(reg.fact_dtypes[c], copy=False)
            for c, v in columns.items()
            if c in reg.fact_dtypes
        }
        lengths = {len(v) for v in cols.values()}
        if len(lengths) > 1:
            raise ValueError(
                f"batch for '{name}' has ragged columns: "
                f"{ {c: len(v) for c, v in cols.items()} }"
            )
        n = lengths.pop() if lengths else 0
        req = QueryRequest(
            rid=next(self._rid), query=name, columns=cols, n_rows=n,
            t_submit=time.perf_counter(),
        )
        self.scheduler.enqueue(name, req, n, block=block, timeout=timeout)
        with self._lock:
            self.stats.rows_in += n
        return req

    def flush(self) -> list[QueryRequest]:
        """Execute all pending requests (coalescing per query, earliest
        deadline first) and return them with results filled. Safe to call
        from any thread; an empty queue is a no-op."""
        return self.scheduler.drain()

    def execute(self, name: str, columns: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """One-shot convenience: submit + flush + return the result."""
        req = self.submit(name, columns)
        self.flush()
        # under a pump another thread's flush may have raced ours and taken
        # this request; either way the result is ready once both finish
        return req.wait(timeout=60.0)

    # -- group dispatch (called by the scheduler) -----------------------------

    def _dispatch_group(self, name: str, group: list[QueryRequest]) -> Future:
        """Execute one scheduler group; returns a future resolving when every
        request in the group is finished (or failed). Never raises — a
        failure lands on the future, and *deterministic* failures are also
        attached to the group's requests here. Transient failures leave the
        requests unsettled on purpose: the scheduler owns them — it requeues
        the group whole (retry/backoff) or, once the policy is exhausted,
        delivers a typed :class:`~repro_torch.errors.RequestFailedError` to
        every waiter via the ``fail`` callback."""
        done: Future = Future()
        try:
            # "dispatch" fault site: the whole group dispatch raises before
            # any stage runs — the canonical transient-retry drill
            maybe_inject("dispatch", token=name)
            reg = self._registered(name)
            if asserts_enabled():
                runtime_assert(len(group) > 0, "dispatched an empty group")
                runtime_assert(
                    all(r.query == name for r in group),
                    f"group for '{name}' contains misrouted request(s) "
                    f"{[r.rid for r in group if r.query != name]}",
                )
                runtime_assert(
                    all(not r.done for r in group),
                    f"group for '{name}' re-dispatches finished request(s) "
                    f"{[r.rid for r in group if r.done]}",
                )
            with self._lock:
                self.stats.flushes += 1
                self.stats.requests_served += len(group)
            if not self.pipelined:
                self._run_group(reg, group)
                done.set_result(group)
                return done
            n = sum(r.n_rows for r in group)
            if reg.sliceable and n > self.max_bucket:
                # oversized spine: the serial chunked path keeps captured
                # graphs bounded at max_bucket; run it off-thread so the
                # pump stays responsive
                f = self.executor.pool.submit(self._run_group, reg, group)

                def _chunked_done(f2, _group=group, _done=done):
                    e = f2.exception()
                    if e is not None:
                        self._settle_dispatch_failure(_group, e)
                        _done.set_exception(e)
                    else:
                        _done.set_result(_group)

                f.add_done_callback(_chunked_done)
                return done
            with self._lock:
                self.stats.pipelined_groups += 1
            cat, n, segments = self._group_batch(reg, group)
            gfut = self._execute_padded_async(reg, cat, n, segments=segments)

            def _complete(f2, _reg=reg, _group=group, _n=n, _done=done):
                try:
                    res = f2.result()
                    self._split_group(_reg, _group, res, _n)
                    _done.set_result(_group)
                except BaseException as e:  # noqa: BLE001
                    self._settle_dispatch_failure(_group, e)
                    _done.set_exception(e)

            gfut.add_done_callback(_complete)
        except BaseException as e:  # noqa: BLE001
            self._settle_dispatch_failure(group, e)
            if not done.done():
                done.set_exception(e)
        return done

    def _settle_dispatch_failure(self, group: list[QueryRequest], e: BaseException) -> None:
        """Route one group-execution failure: deterministic errors are
        attached to the requests immediately; transient ones are left for
        the scheduler (which requeues the group or fails it terminally
        through the ``fail`` callback)."""
        if not isinstance(e, TransientError):
            self._fail_group(group, e)

    def _fail_group(self, group: list[QueryRequest], e: BaseException) -> None:
        """Contain the blast radius: fail this group's requests (waiters
        re-raise from wait()) while the server keeps serving other groups."""
        for r in group:
            if not r.done:
                r.error = e
                r._event.set()

    # -- internals -----------------------------------------------------------

    def _group_batch(
        self, reg: RegisteredQuery, group: list[QueryRequest]
    ) -> tuple[dict[str, np.ndarray], int, Optional[tuple[np.ndarray, int]]]:
        """Concatenate a group into one fact batch (+ segment ids when the
        plan cannot be split positionally)."""
        n = sum(r.n_rows for r in group)
        if len(group) == 1:
            return group[0].columns, n, None
        cat = {
            c: np.concatenate([r.columns[c] for r in group])
            for c in reg.scan_columns
        }
        with self._lock:
            self.stats.coalesced_requests += len(group)
        if reg.sliceable:
            return cat, n, None
        # host boundaries compact data-dependently and aggregates fold the
        # spine, so positional slicing is impossible: thread per-request
        # segment ids through the stage graph instead
        seg_ids = np.repeat(
            np.arange(len(group), dtype=np.int32),
            [r.n_rows for r in group],
        )
        with self._lock:
            self.stats.segmented_batches += 1
        return cat, n, (seg_ids, len(group))

    def _padded_kwargs(
        self,
        reg: RegisteredQuery,
        fact_np: dict[str, np.ndarray],
        n: int,
        segments: Optional[tuple[np.ndarray, int]] = None,
    ) -> dict[str, Any]:
        """Pad ``n`` fact rows to their bucket; returns the kwargs shared by
        ``CompiledPlan.run`` and ``run_async`` (plus bucket accounting)."""
        bucket = row_bucket(n, self.min_bucket)
        fact: dict[str, np.ndarray] = {}
        for c in reg.scan_columns:
            col = fact_np[c]
            if len(col) < bucket:
                col = np.concatenate([col, np.zeros(bucket - len(col), dtype=col.dtype)])
            fact[c] = col
        row_valid = np.arange(bucket) < n
        if segments is not None:
            ids, k = segments
            if len(ids) < bucket:
                ids = np.concatenate([ids, np.zeros(bucket - len(ids), dtype=np.int32)])
            segments = (ids, k)
        schema = tuple((c, str(reg.fact_dtypes[c])) for c in reg.scan_columns)
        key = (reg.compiled.fingerprint, schema, bucket)
        with self._lock:
            if key in self._seen_buckets:
                self.stats.bucket_hits += 1
            else:
                self.stats.bucket_misses += 1
                self._seen_buckets.add(key)
            self.stats.batches_executed += 1
            self.stats.rows_padded += bucket - n

        def track_mid(stage_index: int, b: int) -> None:
            mid_key = (reg.compiled.fingerprint, stage_index, b)
            with self._lock:
                if mid_key in self._seen_mid_buckets:
                    self.stats.mid_bucket_hits += 1
                else:
                    self.stats.mid_bucket_misses += 1
                    self._seen_mid_buckets.add(mid_key)

        return {
            # the padded batch goes to the card here, the group's only upload
            "database": reg.database.replace(reg.fact_table, fact),
            "row_valid": row_valid,
            "params": reg.params if reg.param_names else None,
            "segments": segments,
            "device": self.device,
            # host-boundary outputs re-padded to buckets too, so the stages
            # after a boundary stay on their graphs
            "bucketer": lambda m: row_bucket(m, self.min_bucket),
            "on_mid_bucket": track_mid,
            # the padded fact spine is freshly built per group: single-use
            # (unless the registration opted out via ServeOptions(donate=False))
            "donate": frozenset((reg.fact_table,)) if reg.donate else frozenset(),
        }

    def _execute_padded(self, reg, fact_np, n, segments=None):
        """Serial padded execution (blocks at every stage)."""
        return reg.compiled.run(**self._padded_kwargs(reg, fact_np, n, segments))

    def _execute_padded_async(self, reg, fact_np, n, segments=None) -> Future:
        """Pipelined padded execution; returns ``Future[RunResult]``."""
        return reg.compiled.run_async(
            executor=self.executor, **self._padded_kwargs(reg, fact_np, n, segments),
        )

    def _finish(self, req: QueryRequest) -> None:
        if asserts_enabled():
            runtime_assert(not req.done, f"request {req.rid} finished twice")
            runtime_assert(
                not any(k.startswith("__pv_") for k in (req.result or {})),
                f"request {req.rid} result leaks reserved block column(s) "
                f"{[k for k in (req.result or {}) if k.startswith('__pv_')]}",
            )
        req.done = True
        req.t_done = time.perf_counter()
        req._event.set()

    @staticmethod
    def _positional_results(
        group: list[QueryRequest],
        cols: dict[str, np.ndarray],
        valid: np.ndarray,
    ) -> list[dict[str, np.ndarray]]:
        out, off = [], 0
        for r in group:
            sl = slice(off, off + r.n_rows)
            m = valid[sl]
            out.append({k: v[sl][m] for k, v in cols.items()})
            off += r.n_rows
        return out

    def _split_results(self, reg, group, res, n) -> list[dict[str, np.ndarray]]:
        """Split one executed group's table into per-request column dicts."""
        if reg.sliceable:
            cols = {k: v[:n].cpu().numpy() for k, v in res.table.columns.items()}
            valid = res.table.valid[:n].cpu().numpy()
            return self._positional_results(group, cols, valid)
        if len(group) == 1:
            # a lone host-boundary/aggregate request: no splitting needed
            return [res.table.to_numpy(compact=True)]
        cols = {k: v.cpu().numpy() for k, v in res.table.columns.items()}
        valid = res.table.valid.cpu().numpy()
        if reg.has_aggregate:
            # segmented fold: output row i belongs to request i
            return [{k: v[i:i + 1] for k, v in cols.items()} for i in range(len(group))]
        seg = res.seg.cpu().numpy()
        return [
            {k: v[valid & (seg == i)] for k, v in cols.items()}
            for i in range(len(group))
        ]

    def _split_group(self, reg, group, res, n) -> None:
        """Split one executed group's result back per request and finish
        them. Runs on whichever thread completed the group (the dispatching
        thread for pure graphs, a boundary worker otherwise)."""
        for r, out in zip(group, self._split_results(reg, group, res, n)):
            r.result = out
            self._finish(r)

    def _run_group(self, reg: RegisteredQuery, group: list[QueryRequest]) -> None:
        """Serial group execution (the ``pipelined=False`` baseline, and the
        chunked path for sliceable spines wider than ``max_bucket``)."""
        cat, n, segments = self._group_batch(reg, group)
        if reg.sliceable and n > self.max_bucket:
            # row-aligned output lets a spine wider than max_bucket run as
            # max_bucket-sized chunks, keeping the captured-graph count
            # bounded by log2(max_bucket / min_bucket) + 1 per query
            out_cols: dict[str, list[np.ndarray]] = {}
            out_valid: list[np.ndarray] = []
            for off in range(0, max(n, 1), self.max_bucket):
                span = min(self.max_bucket, n - off) if n else 0
                chunk = {c: v[off:off + span] for c, v in cat.items()}
                table = self._execute_padded(reg, chunk, span).table
                out_valid.append(table.valid[:span].cpu().numpy())
                for k, v in table.columns.items():
                    out_cols.setdefault(k, []).append(v[:span].cpu().numpy())
            cols = {k: np.concatenate(v) for k, v in out_cols.items()}
            valid = np.concatenate(out_valid)
            for r, out in zip(group, self._positional_results(group, cols, valid)):
                r.result = out
                self._finish(r)
            return
        res = self._execute_padded(reg, cat, n, segments=segments)
        self._split_group(reg, group, res, n)

    # -- introspection --------------------------------------------------------

    def recompiles(self) -> int:
        """Stage specializations across every registered query: captures of
        CUDA graphs on the card (new input structures on the CPU). A warm
        bucket adds none."""
        with self._lock:
            regs = list(self.queries.values())
        return sum(r.recompiles for r in regs)

    def stats_snapshot(self) -> dict[str, Any]:
        """Server counters merged with the scheduler's queue gauges and the
        pipelined executor's overlap gauges (what ``db.cache_stats()``
        surfaces under ``"server"``)."""
        out = self.stats.snapshot()
        out.update(self.scheduler.snapshot())
        out["queue_depths"] = self.scheduler.depths()
        out["pipeline"] = self.executor.snapshot()
        plan = get_fault_plan()
        out["faults_injected"] = plan.injected() if plan is not None else {}
        return out


def _dtype_of(v) -> np.dtype:
    """A column's dtype, for a numpy array or a tensor (a session's
    uploaded table)."""
    if isinstance(v, torch.Tensor):
        return torch.empty(0, dtype=v.dtype).numpy().dtype
    return np.asarray(v).dtype
