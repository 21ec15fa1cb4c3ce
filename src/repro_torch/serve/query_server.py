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

**Versioned routing** (the model-lifecycle layer): every registration owns a
:class:`QueryRoute` that can hold *several* :class:`RegisteredQuery`
versions of the same serve name — one live, others staged.
``stage_version`` compiles an incoming version without touching routing,
``warm_version`` replays the route's observed bucket ladder through it (so
its graphs are captured *before* any traffic reaches them), and ``cutover``
atomically swaps the routed version under the scheduler's hold: groups
already dispatched hold their version's registration and complete on it,
groups popped after the swap run the new one — zero dropped requests, zero
captures when the incoming version is warm. ``set_shadow`` mirrors every
coalesced group through a staged version whose results are diffed and
counted but never returned; ``set_split`` routes a deterministic fraction
of groups to staged versions (smooth weighted round-robin, per-version
stats). The route-level token keeps submit handles valid across cutovers —
only a true re-``register`` (new plan under the same name) invalidates
them. A registration's **circuit breaker** trips after
``breaker_threshold`` consecutive dispatch failures onto a fallback plan
compiled with the relational kernels off (``compile_plan(kernels=False)``);
a kernel's own build or launch failure fails its requests and never counts
toward the breaker.

The capture cache holds ``capture.GRAPH_CAPACITY`` graphs for the whole
process, and two warmed versions hold a ladder each: a warmed version's
graph the cache dropped is shown in ``route_snapshot`` (``graphs``,
``graph_evictions``) and counts in the warm deficit a cutover checks, and
``warm_version`` captures it again.

With an artifact store active, ``register`` and ``stage_version`` preload
every bucket structure stored for the plan's stages
(``CompiledPlan.warm_start``): on the card their graphs are captured there,
before the first request, and counted in ``warm_started_buckets``.
Under a verify mode other than ``off`` (the optimizer options' ``verify``,
else ``RAVEN_VERIFY``), ``register`` re-verifies the stage graph it will
serve, abstract execution included, against the registered tables.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
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
    RegistryStateError,
    RequestTimeoutError,
    StaleQueryError,
    TransientError,
    UnknownModelVersionError,
    UnknownQueryError,
    check_params,
)
from repro_torch.exec.faults import RetryPolicy, get_fault_plan, maybe_inject
from repro_torch.exec.pipeline import PipelineExecutor
from repro_torch.exec.scheduler import Scheduler
from repro_torch.exec.stages import seg_bucket
from repro_torch.kernels._build import KernelError
from repro_torch.relational.engine import (
    CompiledPlan,
    Database,
    PhysicalPlan,
    Scan,
    compile_plan,
    get_artifact_store,
    plan_params,
    upload_database,
    walk_plan,
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
    served_by: str = ""  # version label of the registration that served it
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
    warm_started_buckets: int = 0  # bucket structures preloaded from the
    #                                artifact store at registration time
    warm_start_s: float = 0.0    # seconds registration spent preloading them
    cutovers: int = 0            # atomic version swaps completed
    shadow_mirrored_groups: int = 0  # groups mirrored to a shadow version
    warm_replayed_buckets: int = 0   # ladder entries replayed by warm_version
    breaker_trips: int = 0       # registrations degraded to the fallback plan

    def snapshot(self) -> dict[str, int]:
        return dict(self.__dict__)


@dataclass
class VersionStats:
    """Per-version serving counters, kept on the :class:`QueryRoute`."""

    groups: int = 0              # dispatched groups this version executed
    requests: int = 0
    rows: int = 0
    errors: int = 0              # dispatched groups that failed on this
    #                              version — counted even when the scheduler
    #                              retried the group to success, so a rollback
    #                              guard sees trouble before users do
    shadow_groups: int = 0       # mirrored groups this version scored
    shadow_rows: int = 0         # mirrored rows compared against the primary
    shadow_diff_rows: int = 0    # compared rows that were not bitwise equal
    shadow_max_abs_diff: float = 0.0  # largest numeric divergence observed
    shadow_errors: int = 0       # mirrored executions that raised (contained)

    def snapshot(self) -> dict[str, Any]:
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
    version_label: str = "v1"     # which model version this registration runs
    donate: bool = True  # padded entry buffers are single-use
    warmed: bool = False          # warm_version covered the route ladder
    # (bucket, seg_slots) entries this registration has executed or replayed
    # — the per-version warm coverage the cutover gate checks
    warmed_ladder: set = field(default_factory=set)
    # graphs of this registration the capture cache had dropped when
    # warm_version last ran: any dropped since is a warm deficit
    warm_evictions: int = 0
    # circuit breaker: `breaker_threshold` consecutive dispatch failures trip
    # this registration onto a fallback plan compiled with the relational
    # kernels off (fingerprint-forked) — a persistent kernel/compile fault
    # degrades the query instead of failing every request forever
    breaker_threshold: int = 3
    breaker_failures: int = 0     # consecutive failures; reset on success
    breaker_trips: int = 0
    degraded: bool = False
    fallback: Optional[CompiledPlan] = None

    @property
    def active(self) -> CompiledPlan:
        """The plan serving this registration's traffic right now: the
        kernel-free fallback once the breaker tripped (and its compile
        landed), the primary compiled plan otherwise."""
        fb = self.fallback
        return fb if (self.degraded and fb is not None) else self.compiled

    @property
    def recompiles(self) -> int:
        """Stage specializations of this query's compiled plan (fallback
        included once the breaker tripped): captures on the card, new input
        structures on the CPU."""
        fb = self.fallback
        return self.compiled.traces + (fb.traces if fb is not None else 0)

    def graph_deficit(self) -> int:
        """Graphs of this registration the capture cache dropped since
        ``warm_version`` last covered it (0 on the CPU)."""
        return self.compiled.graph_state()[1] - self.warm_evictions

    @property
    def sliceable(self) -> bool:
        """Coalesced output rows stay 1:1 aligned with the input spine, so
        per-request results fall out of positional slicing — no segment ids
        needed. False once a host boundary (compaction) or an aggregate
        (folding) breaks the alignment."""
        return not self.compiled.graph.needs_segments


@dataclass
class QueryRoute:
    """Versioned routing state for one serve name.

    The ``token`` lives here, not on any one registration: submit handles
    stay valid across cutovers (the whole point of a hot swap) and only a
    fresh ``register`` under the same name — a genuinely different query —
    mints a new token and stales old handles. ``ladder`` records every
    (row bucket, segment-slot bucket) combination this route has executed;
    it is exactly what ``warm_version`` must replay through an incoming
    version for a zero-capture cutover.
    """

    name: str
    token: str
    live: str                                     # live version label
    versions: dict[str, RegisteredQuery] = field(default_factory=dict)
    shadow: Optional[str] = None                  # mirrored version label
    split: dict[str, float] = field(default_factory=dict)  # label -> fraction
    stats: dict[str, VersionStats] = field(default_factory=dict)
    ladder: set = field(default_factory=set)      # (bucket, seg_slots) seen
    # columns a submitted batch must carry: the union of scan columns over
    # every version that can currently receive traffic (live, shadow, split)
    required: set = field(default_factory=set)
    cutovers: int = 0
    # entries the last cutover's incoming version had NOT warmed (nonzero
    # only when forced with require_warm=False)
    last_cutover_deficit: int = 0
    _wrr: dict[str, float] = field(default_factory=dict)  # smooth-WRR credit
    # per-version rolling request latencies (ms, bounded window) — the p99
    # signal the registry's rollback guard compares against its baseline
    latencies: dict[str, deque] = field(default_factory=dict, repr=False)

    def version_stats(self, label: str) -> VersionStats:
        st = self.stats.get(label)
        if st is None:
            st = self.stats[label] = VersionStats()
        return st

    def record_latency(self, label: str, ms: float) -> None:
        dq = self.latencies.get(label)
        if dq is None:
            dq = self.latencies[label] = deque(maxlen=256)
        dq.append(float(ms))

    def warm_deficit(self, reg: RegisteredQuery) -> int:
        """Ladder entries ``reg`` has not replayed, plus its graphs the
        capture cache dropped since ``warm_version`` last covered it: what a
        cutover onto it would capture on the request path."""
        return len(self.ladder - reg.warmed_ladder) + reg.graph_deficit()

    def p99_ms(self, label: str) -> float:
        """p99 over the version's rolling latency window (0.0 when empty)."""
        xs = sorted(self.latencies.get(label) or ())
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(len(xs) * 0.99))]

    def snapshot(self) -> dict[str, Any]:
        """The route's state; each version's row also carries the graphs
        its stages hold in the capture cache and those the cache dropped
        (``graphs``, ``graph_evictions``) and its ``warm_deficit``."""
        versions = {}
        for label, reg in self.versions.items():
            graphs, evicted = reg.compiled.graph_state()
            versions[label] = {
                "plan_fingerprint": reg.compiled.fingerprint,
                "warmed": reg.warmed,
                "traces": reg.compiled.traces,
                "degraded": reg.degraded,
                "breaker_failures": reg.breaker_failures,
                "breaker_trips": reg.breaker_trips,
                "fallback_traces": (
                    reg.fallback.traces if reg.fallback is not None else 0
                ),
                "p99_ms": self.p99_ms(label),
                **self.version_stats(label).snapshot(),
                "graphs": graphs,
                "graph_evictions": evicted,
                "warm_deficit": self.warm_deficit(reg),
            }
        return {
            "live": self.live,
            "shadow": self.shadow,
            "split": dict(self.split),
            "cutovers": self.cutovers,
            "last_cutover_deficit": self.last_cutover_deficit,
            "ladder": sorted(self.ladder),
            "versions": versions,
        }


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
        self.queries: dict[str, RegisteredQuery] = {}  # live registrations
        self.routes: dict[str, QueryRoute] = {}        # versioned routing
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
        version_label: str = "v1",
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

        ``version_label`` names this registration in the versioned route
        created for ``name`` (further versions arrive via
        :meth:`stage_version`); ``donate=False`` keeps the padded entry
        buffers out of the donated set; ``breaker_threshold`` is the
        consecutive-failure count that trips this query's circuit breaker
        onto the kernel-free fallback plan. Re-registering an existing name
        replaces its whole route and mints a new token — outstanding submit
        handles go stale.
        """
        token = f"route#{next(self._reg_serial)}"
        reg = self._build_registration(
            name, query, database, fact_table,
            optimized=optimized, params=params, token=token,
            version_label=version_label, donate=donate,
        )
        if breaker_threshold is not None:
            reg.breaker_threshold = max(1, int(breaker_threshold))
        route = QueryRoute(name=name, token=token, live=version_label)
        route.versions[version_label] = reg
        route.required = set(reg.scan_columns)
        with self._lock:
            self.routes[name] = route
            self.queries[name] = reg
        self.scheduler.configure(
            name, max_latency_ms=max_latency_ms, max_pending=max_pending,
            max_coalesce=max_coalesce, retry=retry,
        )
        with self._lock:
            self.stats.queries_registered += 1
        return reg

    def _build_registration(
        self,
        name: str,
        query: PredictionQuery,
        database: dict,
        fact_table: Optional[str] = None,
        *,
        optimized: Optional[tuple[PhysicalPlan, OptimizationReport]] = None,
        params: Optional[dict[str, Any]] = None,
        token: str = "",
        version_label: str = "v1",
        donate: bool = True,
    ) -> RegisteredQuery:
        """Optimize/compile/verify/warm-start one version's registration
        (shared by :meth:`register` and :meth:`stage_version`); installs no
        routing state."""
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
        # warm start: every bucket structure the artifact store holds for
        # this plan's stages, captured on the registered tables now, so
        # previously served shapes replay from the very first submit
        if get_artifact_store() is not None:
            t0 = time.perf_counter()
            warmed = compiled.warm_start(database=db)
            with self._lock:
                self.stats.warm_started_buckets += warmed
                self.stats.warm_start_s += time.perf_counter() - t0
        param_names = frozenset(plan_params(plan))
        bound = dict(params or {})
        check_params(param_names, bound, context=f"query '{name}'")
        scans = [p for p in walk_plan(plan) if isinstance(p, Scan)]
        if fact_table is None:
            fact_table = scans[0].table
        if fact_table not in database:
            raise KeyError(f"fact table '{fact_table}' missing from database")
        scan_columns = [c for s in scans if s.table == fact_table for c in s.columns]
        return RegisteredQuery(
            name=name,
            # plan fingerprints are invariant under :param values
            # (rebinding must not recompile), so the handle guard is a
            # serial token per route, which survives version cutovers
            token=token,
            query_fingerprint=qfp,
            plan=plan,
            report=report,
            compiled=compiled,
            database=db,
            fact_table=fact_table,
            scan_columns=scan_columns,
            # the *full* registered fact schema, not just this plan's scan
            # columns: submit normalizes every provided fact column against
            # it, so a staged version whose optimizer pruned a different
            # subset can serve the same queue
            fact_dtypes={
                c: canonical_dtype(_dtype_of(v))
                for c, v in database[fact_table].items()
            },
            has_aggregate=compiled.graph.has_aggregate,
            param_names=param_names,
            params={k: float(v) for k, v in bound.items()},
            version_label=version_label,
            donate=donate,
        )

    def rebind(self, name: str, params: dict[str, Any]) -> RegisteredQuery:
        """Re-bind ``:param`` values for a registered query: the plan, its
        graphs and the shape buckets are untouched — the new values flow
        into the next execution as runtime inputs (nothing captured).
        Applied to *every* version on the route: a staged or shadow version
        must score the same binding the live one answers with."""
        reg = self._registered(name)
        check_params(
            reg.param_names, params, require_all=False, context=f"query '{name}'"
        )
        vals = {k: float(v) for k, v in params.items()}
        with self._lock:
            route = self.routes.get(name)
            regs = list(route.versions.values()) if route is not None else [reg]
        for r in regs:
            r.params.update(vals)
        return reg

    # -- model-version lifecycle ---------------------------------------------

    def _route(self, name: str) -> QueryRoute:
        route = self.routes.get(name)
        if route is None:
            raise UnknownQueryError(
                f"no query registered under '{name}' — registered: "
                f"{sorted(self.routes) or '(none)'}"
            )
        return route

    def _version(self, route: QueryRoute, label: str) -> RegisteredQuery:
        reg = route.versions.get(label)
        if reg is None:
            raise UnknownModelVersionError(
                f"route '{route.name}' has no staged version {label!r} — "
                f"staged: {sorted(route.versions)}"
            )
        return reg

    @staticmethod
    def _refresh_required(route: QueryRoute) -> None:
        """Recompute the submit-time required column set (caller holds the
        server lock): the union over every version currently routable —
        live, shadow, and split targets."""
        labels = {route.live, *route.split}
        if route.shadow is not None:
            labels.add(route.shadow)
        route.required = {
            c for lb in labels for c in route.versions[lb].scan_columns
        }

    def stage_version(
        self,
        name: str,
        query: PredictionQuery,
        database: dict,
        *,
        version_label: str,
        optimized: Optional[tuple[PhysicalPlan, OptimizationReport]] = None,
        params: Optional[dict[str, Any]] = None,
    ) -> RegisteredQuery:
        """Compile an incoming version for ``name`` without touching routing.

        The staged registration shares the route's token and fact table;
        its scan columns may differ from the live version's (a retrained
        model reads different features) but must stay inside the fact
        schema the route was registered over, with identical canonical
        dtypes — submitted batches are validated and normalized against
        that schema, so every routable version can serve the same queue.
        When an artifact store is active the compiled stages warm-start
        from it here; live bucket coverage comes from :meth:`warm_version`.
        """
        route = self._route(name)
        live = self._version(route, route.live)
        reg = self._build_registration(
            name, query, database, live.fact_table,
            optimized=optimized,
            params=params if params is not None else dict(live.params),
            token=route.token, version_label=version_label,
            donate=live.donate,
        )
        outside = sorted(set(reg.scan_columns) - set(live.fact_dtypes))
        if outside:
            raise RegistryStateError(
                f"version {version_label!r} of '{name}' reads columns "
                f"{outside} outside the fact schema the route was "
                f"registered over — re-serve the query instead"
            )
        drift = {
            c: (str(reg.fact_dtypes[c]), str(live.fact_dtypes[c]))
            for c in reg.scan_columns
            if reg.fact_dtypes[c] != live.fact_dtypes[c]
        }
        if drift:
            raise RegistryStateError(
                f"version {version_label!r} of '{name}' disagrees with the "
                f"route's registered submit dtypes: {drift}"
            )
        with self._lock:
            reg.breaker_threshold = live.breaker_threshold
            route.versions[version_label] = reg
            route.version_stats(version_label)  # materialize the counter row
        return reg

    def warm_version(self, name: str, version_label: str) -> int:
        """Replay the route's observed bucket ladder through a staged
        version so every (row bucket, segment-slot) graph it will serve is
        captured *now*, off the request path — the zero-capture guarantee an
        atomic cutover depends on. Returns the number of ladder entries
        replayed; marks the version warm.

        Replay goes through the exact ``_padded_kwargs`` path real traffic
        takes (zero-filled rows, all-invalid mask), so the graphs it
        captures are the ones post-cutover traffic replays. Where the
        capture cache dropped a graph of this version since its last warm,
        the whole ladder is replayed: a held graph only replays, a dropped
        one is captured again.
        """
        route = self._route(name)
        reg = self._version(route, version_label)
        with self._lock:
            ladder = set(route.ladder) or {(self.min_bucket, 0)}
            pending = sorted(ladder if reg.graph_deficit() else ladder - reg.warmed_ladder)
        replayed = 0
        for bucket, seg_slots in pending:
            fact = {
                c: np.zeros(bucket, dtype=reg.fact_dtypes[c])
                for c in reg.scan_columns
            }
            segments = None
            if seg_slots:
                segments = (np.zeros(bucket, dtype=np.int32), seg_slots)
            self._execute_padded(reg, fact, bucket, segments=segments)
            replayed += 1
        with self._lock:
            reg.warmed = True
            reg.warm_evictions = reg.compiled.graph_state()[1]
            self.stats.warm_replayed_buckets += replayed
        return replayed

    def set_shadow(self, name: str, version_label: Optional[str]) -> None:
        """Mirror every coalesced group for ``name`` through a staged
        version (None disables). The shadow scores its own padded copy of
        the batch on a boundary-pool thread, its results are diffed against
        the primary's and counted in the route's per-version stats — and
        are never attached to any request."""
        route = self._route(name)
        if version_label is not None:
            self._version(route, version_label)
        with self._lock:
            route.shadow = version_label
            self._refresh_required(route)

    def set_split(self, name: str, split: dict[str, float]) -> None:
        """Route a fraction of dispatched groups to staged versions.

        ``split`` maps version labels to fractions in [0, 1); the live
        version serves the remainder. Selection is smooth weighted
        round-robin — deterministic, no RNG — so a 0.25 split sends exactly
        one group in four to the staged version. Pass ``{}`` to clear."""
        route = self._route(name)
        total = 0.0
        for label, frac in split.items():
            self._version(route, label)
            if not 0.0 <= frac < 1.0:
                raise RegistryStateError(
                    f"split fraction for {label!r} must be in [0, 1), "
                    f"got {frac}"
                )
            if label == route.live:
                raise RegistryStateError(
                    f"{label!r} is the live version — it already serves the "
                    f"unsplit remainder"
                )
            total += frac
        if total >= 1.0:
            raise RegistryStateError(
                f"split fractions sum to {total} — the live version must "
                f"keep a nonzero remainder"
            )
        with self._lock:
            route.split = dict(split)
            route._wrr.clear()
            self._refresh_required(route)

    def cutover(
        self, name: str, version_label: str, *, require_warm: bool = True
    ) -> RegisteredQuery:
        """Atomically make a staged version the live one.

        The swap happens under the scheduler's hold: no group can be popped
        while routing changes, groups already dispatched hold their
        version's registration and complete on it (zero dropped requests),
        and every group popped afterwards runs the incoming version. With
        ``require_warm`` (default) the incoming version must have replayed
        the route's full bucket ladder (:meth:`warm_version`) and kept every
        graph it captured, so the swap also captures nothing;
        ``require_warm=False`` forces the swap and records the warm deficit
        on the route. The route token is untouched — outstanding submit
        handles keep working across the swap.
        """
        route = self._route(name)
        incoming = self._version(route, version_label)
        with self.scheduler.hold():
            with self._lock:
                deficit = route.warm_deficit(incoming)
                if require_warm and (deficit or not incoming.warmed):
                    raise RegistryStateError(
                        f"version {version_label!r} of '{name}' is not warm "
                        f"({deficit} of {len(route.ladder)} bucket(s) cold) "
                        f"— call warm_version() first, or force with "
                        f"require_warm=False"
                    )
                route.last_cutover_deficit = deficit
                route.live = version_label
                route.split.pop(version_label, None)
                route._wrr.clear()
                if route.shadow == version_label:
                    route.shadow = None
                route.cutovers += 1
                self._refresh_required(route)
                self.queries[name] = incoming
                self.stats.cutovers += 1
        return incoming

    def retire_version(self, name: str, version_label: str) -> None:
        """Drop a non-live staged version from the route (its compiled plan
        stays in the engine cache until evicted). Refuses to retire the
        live version or one still designated shadow / holding split
        traffic."""
        route = self._route(name)
        self._version(route, version_label)
        with self._lock:
            if version_label == route.live:
                raise RegistryStateError(
                    f"cannot retire live version {version_label!r} of "
                    f"'{name}' — cut over to another version first"
                )
            if route.shadow == version_label or version_label in route.split:
                raise RegistryStateError(
                    f"version {version_label!r} of '{name}' still receives "
                    f"shadow/split traffic — clear that first"
                )
            del route.versions[version_label]
            self._refresh_required(route)

    def route_snapshot(self, name: str) -> dict[str, Any]:
        """One route's versioned state (live/shadow/split, ladder,
        per-version counters and graphs) — the operator-facing stats
        surface."""
        route = self._route(name)
        with self._lock:
            return route.snapshot()

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
        with self._lock:
            route = self.routes.get(name)
            required = (
                set(route.required) if route is not None else set(reg.scan_columns)
            )
        missing = [c for c in sorted(required) if c not in columns]
        if missing:
            raise KeyError(f"batch for '{name}' missing columns {missing}")
        # normalize dtypes to the registered fact schema so every
        # bucket-sized batch maps onto the same captured graph. Keep every
        # schema column the caller provided (not just the live version's
        # scan set): shadow and split versions of the same route may read
        # columns the live plan pruned away
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
        reg: Optional[RegisteredQuery] = None
        try:
            # "dispatch" fault site: the whole group dispatch raises before
            # any stage runs — the canonical transient-retry drill
            maybe_inject("dispatch", token=name)
            reg = self._registered(name)
            route = self.routes.get(name)
            shadow_reg = None
            if route is not None:
                reg, shadow_reg = self._pick_version(route)
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
                if route is not None:
                    st = route.version_stats(reg.version_label)
                    st.groups += 1
                    st.requests += len(group)
                    st.rows += sum(r.n_rows for r in group)
            for r in group:
                r.served_by = reg.version_label

            def _mirror() -> None:
                # score the same group on the shadow version, off the
                # dispatch path; diffing waits on `done`, so the mirror can
                # never race (or touch) the primary's request results
                if shadow_reg is not None:
                    self.executor.pool.submit(
                        self._mirror_shadow, route, shadow_reg, group, done
                    )

            if not self.pipelined:
                self._run_group(reg, group)
                self._record_success(reg)
                done.set_result(group)
                _mirror()
                return done
            n = sum(r.n_rows for r in group)
            if reg.sliceable and n > self.max_bucket:
                # oversized spine: the serial chunked path keeps captured
                # graphs bounded at max_bucket; run it off-thread so the
                # pump stays responsive
                f = self.executor.pool.submit(self._run_group, reg, group)

                def _chunked_done(f2, _reg=reg, _group=group, _done=done):
                    e = f2.exception()
                    if e is not None:
                        self._settle_dispatch_failure(_reg, _group, e)
                        _done.set_exception(e)
                    else:
                        self._record_success(_reg)
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
                    self._record_success(_reg)
                    _done.set_result(_group)
                except BaseException as e:  # noqa: BLE001
                    self._settle_dispatch_failure(_reg, _group, e)
                    _done.set_exception(e)

            gfut.add_done_callback(_complete)
            _mirror()
        except BaseException as e:  # noqa: BLE001
            self._settle_dispatch_failure(reg, group, e)
            if not done.done():
                done.set_exception(e)
        return done

    def _settle_dispatch_failure(
        self,
        reg: Optional[RegisteredQuery],
        group: list[QueryRequest],
        e: BaseException,
    ) -> None:
        """Route one group-execution failure: deterministic errors are
        attached to the requests immediately; transient ones are left for
        the scheduler (which requeues the group or fails it terminally
        through the ``fail`` callback). Either way the failure counts toward
        the serving version's error rate and, unless a kernel failed to
        build or launch (:class:`~repro_torch.kernels._build.KernelError`),
        its circuit breaker: a broken kernel fails its requests loudly and
        is never replaced by the plain composition."""
        if not isinstance(e, TransientError):
            self._fail_group(group, e)
        if reg is not None:
            self._record_failure(reg, breaker=not isinstance(e, KernelError))

    def _record_failure(self, reg: RegisteredQuery, breaker: bool = True) -> None:
        trip = False
        with self._lock:
            route = self.routes.get(reg.name)
            if route is not None:
                route.version_stats(reg.version_label).errors += 1
            if not breaker:
                return
            reg.breaker_failures += 1
            if (
                not reg.degraded
                and reg.fallback is None
                and reg.breaker_failures >= reg.breaker_threshold
            ):
                # claim the trip under the lock; compile outside it
                reg.degraded = True
                trip = True
        if trip:
            self._degrade(reg)

    def _record_success(self, reg: RegisteredQuery) -> None:
        with self._lock:
            reg.breaker_failures = 0

    def _degrade(self, reg: RegisteredQuery) -> None:
        """Trip the circuit breaker: compile this registration's plan with
        the relational kernels off (``compile_plan(kernels=False)``, a mode
        of this compile alone: no other compile in the process sees it) and
        route its traffic through the result. The mode token forks the
        fallback's plan and stage fingerprints from the primary's. Join and
        Aggregate then run the torch composition in place of
        ``gather_join`` and ``segment_agg``; its sums run in another order
        than ``segment_agg``'s fixed block order, so on the card the
        fallback equals the primary bitwise on dyadic data and within
        float32 rounding elsewhere (``featurize`` and ``tree_gemm`` have no
        such mode). Plans with no Join/Aggregate fork to the same
        fingerprint and the "fallback" is the primary again. A kernel's own
        build or launch failure never reaches here
        (:meth:`_settle_dispatch_failure`)."""
        try:
            fb = compile_plan(reg.plan, kernels=False)
            if get_artifact_store() is not None:
                fb.warm_start(database=reg.database)
        except BaseException:  # noqa: BLE001
            # fallback compile failed too: release the claim so the next
            # failure can re-trip; traffic keeps flowing on the primary
            with self._lock:
                reg.degraded = False
            return
        with self._lock:
            reg.fallback = fb
            reg.breaker_trips += 1
            self.stats.breaker_trips += 1

    def _pick_version(
        self, route: QueryRoute
    ) -> tuple[RegisteredQuery, Optional[RegisteredQuery]]:
        """Choose the version serving this group, plus the shadow (if set).

        Split traffic uses smooth weighted round-robin — every label's
        credit grows by its weight each pick, the largest credit wins and
        pays back the total — so the selection is deterministic (no RNG) and
        a 0.25 split sends exactly every fourth group to the staged version,
        interleaved rather than bursty.
        """
        with self._lock:
            shadow_reg = (
                route.versions.get(route.shadow) if route.shadow else None
            )
            if not route.split:
                return route.versions[route.live], shadow_reg
            weights = dict(route.split)
            weights[route.live] = 1.0 - sum(weights.values())
            for label, w in weights.items():
                route._wrr[label] = route._wrr.get(label, 0.0) + w
            pick = max(
                route._wrr,
                key=lambda lb: (route._wrr[lb], lb == route.live, lb),
            )
            route._wrr[pick] -= sum(weights.values())
            return route.versions[pick], shadow_reg

    def _mirror_shadow(
        self,
        route: QueryRoute,
        shadow_reg: RegisteredQuery,
        group: list[QueryRequest],
        primary_done: Future,
    ) -> None:
        """Score a mirrored copy of one coalesced group on the shadow
        version (boundary-pool thread) and diff it against what the primary
        actually returned. It builds its own padded batch from the
        requests' host columns, uploaded and replayed on this thread's
        stream, so it never reads the dispatcher's padded buffers; it never
        touches request state: a shadow failure is counted on the route,
        not raised, and shadow results are unreachable from any response."""
        label = shadow_reg.version_label
        try:
            n = sum(r.n_rows for r in group)
            if len(group) == 1:
                cat = dict(group[0].columns)
            else:
                cat = {
                    c: np.concatenate([r.columns[c] for r in group])
                    for c in shadow_reg.scan_columns
                }
            segments = None
            if len(group) > 1 and not shadow_reg.sliceable:
                seg_ids = np.repeat(
                    np.arange(len(group), dtype=np.int32),
                    [r.n_rows for r in group],
                )
                segments = (seg_ids, len(group))
            res = self._execute_padded(shadow_reg, cat, n, segments=segments)
            shadow_out = self._split_results(shadow_reg, group, res, n)
            primary_done.result(timeout=60.0)
            diff_rows, max_diff, rows = self._diff_shadow(group, shadow_out)
            with self._lock:
                st = route.version_stats(label)
                st.shadow_groups += 1
                st.shadow_rows += rows
                st.shadow_diff_rows += diff_rows
                st.shadow_max_abs_diff = max(st.shadow_max_abs_diff, max_diff)
                self.stats.shadow_mirrored_groups += 1
        except BaseException:  # noqa: BLE001 — contained, counted, never raised
            with self._lock:
                route.version_stats(label).shadow_errors += 1

    @staticmethod
    def _diff_shadow(
        group: list[QueryRequest],
        shadow_out: list[dict[str, np.ndarray]],
    ) -> tuple[int, float, int]:
        """Compare shadow per-request results against the primary's returned
        ones: (rows not bitwise-equal, largest numeric divergence, rows
        compared). A column-set or row-count mismatch counts every primary
        row as differing — a shape drift is the loudest possible diff."""
        diff_rows, max_diff, rows = 0, 0.0, 0
        for req, sh in zip(group, shadow_out):
            pr = req.result or {}
            n_pr = len(next(iter(pr.values()))) if pr else 0
            rows += n_pr
            n_sh = len(next(iter(sh.values()))) if sh else 0
            if sorted(pr) != sorted(sh) or n_pr != n_sh:
                diff_rows += n_pr
                continue
            row_diff = np.zeros(n_pr, dtype=bool)
            for k, pv in pr.items():
                sv = np.asarray(sh[k])
                pv = np.asarray(pv)
                neq = pv != sv
                if pv.dtype.kind == "f":
                    neq &= ~(np.isnan(pv) & np.isnan(sv))
                    d = np.abs(
                        np.nan_to_num(pv.astype(np.float64))
                        - np.nan_to_num(sv.astype(np.float64))
                    )
                    if d.size:
                        max_diff = max(max_diff, float(d.max()))
                row_diff |= neq.reshape(n_pr, -1).any(axis=1)
            diff_rows += int(row_diff.sum())
        return diff_rows, max_diff, rows

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
        # key on the *active* plan: a breaker-degraded registration serves
        # (and warms buckets for) its fallback's fingerprint
        active_fp = reg.active.fingerprint
        schema = tuple((c, str(reg.fact_dtypes[c])) for c in reg.scan_columns)
        key = (active_fp, schema, bucket)
        # (row bucket, segment-slot bucket) is exactly the specialization
        # key (the segment *count* is a runtime scalar): recording it on the
        # route is what lets warm_version replay an incoming version into
        # full coverage before a cutover
        entry = (bucket, seg_bucket(segments[1]) if segments is not None else 0)
        with self._lock:
            if key in self._seen_buckets:
                self.stats.bucket_hits += 1
            else:
                self.stats.bucket_misses += 1
                self._seen_buckets.add(key)
            self.stats.batches_executed += 1
            self.stats.rows_padded += bucket - n
            reg.warmed_ladder.add(entry)
            route = self.routes.get(reg.name)
            if route is not None:
                route.ladder.add(entry)

        def track_mid(stage_index: int, b: int) -> None:
            mid_key = (active_fp, stage_index, b)
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
        return reg.active.run(**self._padded_kwargs(reg, fact_np, n, segments))

    def _execute_padded_async(self, reg, fact_np, n, segments=None) -> Future:
        """Pipelined padded execution; returns ``Future[RunResult]``."""
        return reg.active.run_async(
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
        if req.served_by:
            with self._lock:
                route = self.routes.get(req.query)
                if route is not None:
                    route.record_latency(
                        req.served_by, (req.t_done - req.t_submit) * 1e3
                    )
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
        """Stage specializations across every registered version (staged
        and shadow versions included — a warm cutover must not move this):
        captures of CUDA graphs on the card (new input structures on the
        CPU). A warm bucket adds none."""
        with self._lock:
            regs = {
                id(r): r
                for route in self.routes.values()
                for r in route.versions.values()
            }
            for r in self.queries.values():
                regs.setdefault(id(r), r)
        return sum(r.recompiles for r in regs.values())

    def stats_snapshot(self) -> dict[str, Any]:
        """Server counters merged with the scheduler's queue gauges, the
        pipelined executor's overlap gauges, and per-route version state
        (what ``db.cache_stats()`` surfaces under ``"server"``)."""
        out = self.stats.snapshot()
        out.update(self.scheduler.snapshot())
        out["queue_depths"] = self.scheduler.depths()
        out["pipeline"] = self.executor.snapshot()
        plan = get_fault_plan()
        out["faults_injected"] = plan.injected() if plan is not None else {}
        with self._lock:
            out["routes"] = {
                name: route.snapshot() for name, route in self.routes.items()
            }
        return out


def _dtype_of(v) -> np.dtype:
    """A column's dtype, for a numpy array or a tensor (a session's
    uploaded table)."""
    if isinstance(v, torch.Tensor):
        return torch.empty(0, dtype=v.dtype).numpy().dtype
    return np.asarray(v).dtype
