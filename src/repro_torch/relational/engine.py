"""Physical plans + execution for the columnar PyTorch data engine.

A plan is a tree of operators over a database (dict of named column-dicts).
Lowering splits the plan at host boundaries (``MLUdf``) into a
:class:`~repro_torch.exec.stages.StageGraph`: maximal pure segments run on
the plan's device — the card unless the caller asks for the CPU — each
captured on the card into one CUDA graph per input structure and replayed
(:mod:`repro_torch.exec.capture`, the port's ``jax.jit``), so an
MLtoSQL-compiled model runs with the scans/joins/filters around it in one
replay, while MLUdf stages run the interpreted numpy pipeline on the host
(the Spark→Python-UDF→ML-runtime boundary, with its copies and per-batch
overheads). This module owns the plan-node definitions, the host→device
upload with its baked dim-table sorts, the capture/trace accounting and
the fingerprint-keyed compiled-plan cache on top of the stage graph.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.exec.faults import maybe_inject
from repro_torch.distributed.collectives import (
    all_gather_rows,
    axis_group,
    axis_index,
    axis_size,
)
from repro_torch.relational.expr import Expr
from repro_torch.relational.table import Table, to_device

# ---------------------------------------------------------------------------
# Plan nodes
# ---------------------------------------------------------------------------


@dataclass
class Scan:
    table: str
    columns: list[str]  # columns actually read (projection pushdown target)


@dataclass
class Join:
    """Foreign-key join: gather dim columns onto the fact spine."""

    child: "PhysicalPlan"
    dim_table: str
    fact_key: str
    dim_key: str
    dim_columns: list[str]  # dim columns to bring in (pushdown target)


@dataclass
class Filter:
    child: "PhysicalPlan"
    expr: Expr


@dataclass
class Project:
    child: "PhysicalPlan"
    keep: Optional[list[str]]  # None -> pass all child columns through
    exprs: dict[str, Expr] = field(default_factory=dict)


@dataclass
class MLUdf:
    """Host-boundary pipeline invocation (interpreted 'ML runtime')."""

    child: "PhysicalPlan"
    pipeline: Any  # TrainedPipeline
    output_names: list[str]  # graph outputs -> column names
    batch_size: int = 10_000
    # upstream block columns (split-lowering cut values) this node is the
    # last consumer of — dropped from its output schema
    consumes: tuple[str, ...] = ()


@dataclass
class TensorOp:
    """Fused tensor program (MLtoDNN output): ``fn(cols) -> cols``, an
    ``nn.Module`` whose buffers the engine moves to the run's device."""

    child: "PhysicalPlan"
    fn: Callable[[dict[str, torch.Tensor]], dict[str, torch.Tensor]]
    output_names: list[str]
    # upstream block columns this node is the last consumer of (see MLUdf)
    consumes: tuple[str, ...] = ()


@dataclass
class Aggregate:
    child: "PhysicalPlan"
    aggs: list[tuple[str, str, str]]  # (out_name, op{sum,count,mean,min,max}, col)


PhysicalPlan = Union[Scan, Join, Filter, Project, MLUdf, TensorOp, Aggregate]


def plan_children(p: PhysicalPlan) -> list[PhysicalPlan]:
    return [] if isinstance(p, Scan) else [p.child]


def walk_plan(p: PhysicalPlan):
    yield p
    for c in plan_children(p):
        yield from walk_plan(c)


# ---------------------------------------------------------------------------
# Lowering: plan -> StageGraph (repro_torch.exec.stages)
# ---------------------------------------------------------------------------

from repro_torch.exec.stages import (  # noqa: E402  (plan nodes must exist first)
    DIMSORT_KEY,
    PARAMS_KEY,
    ROW_SEG_KEY,
    ROW_VALID_KEY,
    SEG_COUNT_KEY,
    SEG_SLOTS_KEY,
    VOLATILE_KEYS,
    RunResult,
    StageGraph,
    build_stage_graph,
    env_device,
    run_graph,
    seg_bucket,
)
from repro_torch.exec import capture  # noqa: E402
from repro_torch.exec.artifact_store import TensorSpec, env_digest  # noqa: E402


def plan_fingerprint(plan: PhysicalPlan, pins: Optional[list] = None,
                     kernels: Optional[bool] = None) -> str:
    """Canonical content hash of a physical plan.

    Structurally identical plans hash equal. Opaque callables hash by
    identity and are reported via ``pins``; the compiled-plan cache keeps
    those alive so a fingerprint can never alias a dead closure's recycled
    id. Plans containing Join/Aggregate ops additionally fold in the
    relational-kernel mode token (``kernels``, else the ``RAVEN_KERNELS``
    knob's), so a plan cached under one mode is never served under the
    other.
    """
    from repro_torch.core.fingerprint import fingerprint
    from repro_torch.kernels.ops import kernel_mode_token

    extra = (
        [kernel_mode_token(kernels)]
        if any(isinstance(p, (Join, Aggregate)) for p in walk_plan(plan))
        else []
    )
    return fingerprint(plan, *extra, pins=pins)


@dataclass
class CacheStats:
    """Module-level compiled-plan cache accounting.

    ``traces`` counts stage specializations across all entries, as the
    reference counts XLA traces: on the card each is a capture of a CUDA
    graph, on the CPU the first call of a new input structure (the CPU runs
    eagerly). ``stage_traces`` breaks the same count down per stage
    fingerprint. ``replays`` counts graph replays and
    ``capture_input_copies`` the per-call inputs they copied into their
    graphs' buffers; ``graphs``/``graph_bytes`` in the snapshot are the
    graphs held and the card memory they hold, ``graph_evictions`` the
    graphs the capture cache dropped to stay within its capacity.
    ``disk_hits``/``disk_misses`` count the artifact store's loads that
    skipped work (a persisted plan, a stored bucket structure) against
    those that found nothing."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    traces: int = 0
    stage_traces: dict[str, int] = field(default_factory=dict)
    replays: int = 0
    capture_input_copies: int = 0
    disk_hits: int = 0
    disk_misses: int = 0

    def snapshot(self) -> dict[str, Any]:
        from repro_torch.exec import capture

        graphs, graph_bytes = capture.held()
        return {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions, "traces": self.traces,
            "stage_traces": dict(self.stage_traces), "replays": self.replays,
            "capture_input_copies": self.capture_input_copies,
            "graphs": graphs, "graph_bytes": graph_bytes,
            "graph_evictions": capture.evictions(),
            "disk_hits": self.disk_hits, "disk_misses": self.disk_misses,
        }


PLAN_CACHE_STATS = CacheStats()
_STATS_LOCK = threading.Lock()  # stage runners count from several threads
_PLAN_CACHE: "dict[str, CompiledPlan]" = {}  # insertion-ordered: LRU via re-insert
PLAN_CACHE_CAPACITY = 64


def clear_plan_cache() -> None:
    """Empty the plan cache and its accounting (the graphs captured for
    plans still referenced elsewhere stay with their stages' runners)."""
    _PLAN_CACHE.clear()
    PLAN_CACHE_STATS.hits = PLAN_CACHE_STATS.misses = 0
    PLAN_CACHE_STATS.evictions = PLAN_CACHE_STATS.traces = 0
    PLAN_CACHE_STATS.replays = PLAN_CACHE_STATS.capture_input_copies = 0
    PLAN_CACHE_STATS.disk_hits = PLAN_CACHE_STATS.disk_misses = 0
    PLAN_CACHE_STATS.stage_traces.clear()


# The process-wide artifact store (disk tier under the in-memory LRU above).
# ``repro_torch.connect(cache_dir=...)`` installs one; stage runners consult
# it on each new bucket structure, so even CompiledPlans already resident in
# the LRU pick up (or populate) the disk tier of whichever store is active.
_ARTIFACT_STORE: Optional[Any] = None


def set_artifact_store(store: Optional[Any]) -> Optional[Any]:
    """Install (or clear, with None) the process-wide artifact store;
    returns the previous one."""
    global _ARTIFACT_STORE
    prev, _ARTIFACT_STORE = _ARTIFACT_STORE, store
    return prev


def get_artifact_store() -> Optional[Any]:
    return _ARTIFACT_STORE


# -- the uploaded database and its baked dim-table sort orders ---------------
# Dim tables are frozen at registration, so a Join's sorted key order is
# computed once per uploaded database, on the host, from the host copy of
# the keys the upload kept: a request never copies device memory back to the
# host to learn the order. Entries carry a zero-length "unique" marker when
# the keys are duplicate-free: that is what lets the Join step use the
# gather-join kernel. On a card, unique keys whose range is small gain the
# kernel's direct-address index (the plain version searches), and the Join
# step keeps in the entry ("payloads") each sorted payload it builds and the
# kernel's records it makes from the index, so all are built once.

DENSE_SLOTS_PER_KEY = 4  # an index may hold up to 4 slots for every key...
DENSE_MAX_SLOTS = 1 << 24  # ...and 2^24 in all: 64 MB, and 256 MB of records at P <= 3


def dense_index(sk: np.ndarray) -> Optional[tuple[np.ndarray, int]]:
    """The gather-join kernel's direct-address index of sorted unique keys
    ``sk``: ``(index, lo)`` with ``index[k - lo]`` the position of key ``k``
    in ``sk`` or -1, int32; None where ``sk`` is empty or the keys span more
    than ``DENSE_SLOTS_PER_KEY`` slots a key or ``DENSE_MAX_SLOTS``. Offsets
    are taken in int64, so no key wraps."""
    if sk.size == 0:
        return None
    lo = int(sk[0])
    span = int(sk[-1]) - lo + 1
    if span > DENSE_SLOTS_PER_KEY * sk.size or span > DENSE_MAX_SLOTS:
        return None
    index = np.full(span, -1, np.int32)
    index[sk.astype(np.int64) - lo] = np.arange(sk.size, dtype=np.int32)
    return index, lo


def dimsort_entry(keys: np.ndarray, device) -> dict[str, Any]:
    """Baked sort data for one host dim-key column, on ``device``: the keys
    sorted, the stable argsort permutation (int32), the uniqueness marker
    and, on a card, the kernel's :func:`dense_index` ("index", and its first
    key "lo") where there is one."""
    nk = np.ascontiguousarray(keys)
    order = np.argsort(nk, kind="stable")
    sk = nk[order]
    entry: dict[str, Any] = {
        "keys": torch.from_numpy(sk).to(device),
        "order": torch.from_numpy(order.astype(np.int32)).to(device),
    }
    if sk.size == 0 or not np.any(sk[1:] == sk[:-1]):
        entry["unique"] = torch.zeros((0,), dtype=torch.int32, device=device)
        dense = dense_index(sk) if torch.device(device).type == "cuda" else None
        if dense is not None:
            entry["index"] = torch.from_numpy(dense[0]).to(device)
            entry["lo"] = dense[1]
    return entry


class Database(dict):
    """Tables on one device (table -> column -> tensor), as
    :func:`upload_database` returns them. It keeps the host copy of every
    integer column it uploaded from numpy and each Join key's baked sort,
    computed on first use."""

    def __init__(self, tables: dict, device: torch.device, host: dict,
                 base: Optional[tuple["Database", str]] = None):
        super().__init__(tables)
        self.device = device
        self._host = host  # (table, column) -> host copy of an integer column
        self._sorts: dict[tuple[str, str], dict[str, Any]] = {}
        # (database, table) where this one is that database with the table
        # replaced: the sorts of its other tables are that database's
        self._base = base

    def replace(self, table: str, columns: dict) -> "Database":
        """This database with ``table``'s columns replaced by ``columns``,
        uploaded to its device (the only upload); the other tables are the
        same tensors, and their Join sorts are computed once, here."""
        new = upload_database({table: columns}, self.device)
        host = {k: v for k, v in self._host.items() if k[0] != table}
        host.update(new._host)
        return Database({**self, table: new[table]}, self.device, host, (self, table))

    @property
    def replaced(self) -> frozenset:
        """The table :meth:`replace` put in (uploaded for this database
        only, as a one-shot call's batch is), or none."""
        return frozenset() if self._base is None else frozenset((self._base[1],))

    def dimsort(self, table: str, column: str) -> dict[str, Any]:
        if self._base is not None and table != self._base[1]:
            return self._base[0].dimsort(table, column)
        key = (table, column)
        if key not in self._sorts:
            host = self._host.get(key)
            if host is None:  # a tensor the caller put there: one copy back
                host = self[table][column].cpu().numpy()
            self._sorts[key] = dimsort_entry(host, self.device)
        return self._sorts[key]


def upload_database(database: dict, device=None) -> Database:
    """Every table onto ``device`` (default ``"cuda"``), 64-bit columns
    demoted to 32-bit as the reference's upload does. Tensors already there
    are kept as they are. Upload a database once and pass the result to
    every run: its Join key sorts are then computed once, from host copies."""
    dev = resolve_device(device)
    if isinstance(database, Database) and database.device == dev:
        return database
    tables: dict[str, dict[str, torch.Tensor]] = {}
    host: dict[tuple[str, str], np.ndarray] = {}
    for t, cols in database.items():
        tables[t] = {}
        for c, v in cols.items():
            col = to_device(v, dev)
            if not isinstance(v, torch.Tensor) and not col.is_floating_point():
                host[(t, c)] = to_device(v, "cpu").numpy()
            tables[t][c] = col
    return Database(tables, dev, host)


def place_programs(plan: PhysicalPlan, device: torch.device) -> None:
    """Move every TensorOp program of ``plan`` whose tensors lie elsewhere
    to ``device`` (the optimizer builds them on the CPU)."""
    for p in walk_plan(plan):
        if isinstance(p, TensorOp) and isinstance(p.fn, torch.nn.Module):
            t = next(itertools.chain(p.fn.buffers(), p.fn.parameters()), None)
            if t is not None and t.device != device:
                p.fn.to(device)


def build_env(
    plan: PhysicalPlan,
    database: dict,
    device: torch.device,
    row_valid,
    params: Optional[dict[str, Any]],
    segments: Optional[tuple[np.ndarray, int]],
) -> dict[str, Any]:
    """The execution environment of ``plan`` on ``device``: the tables
    (uploaded unless already there), the row mask, the ``:param`` slots,
    the request segments and every Join's baked dim sort."""
    db = upload_database(database, device)
    env: dict[str, Any] = dict(db)
    if row_valid is not None:
        env[ROW_VALID_KEY] = to_device(row_valid, device).to(torch.bool)
    if params:
        # float32 0-d tensors: a bound value is a runtime input
        env[PARAMS_KEY] = {
            k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in params.items()
        }
    if segments is not None:
        seg_ids, count = segments
        # slot count is power-of-two bucketed; the real request count
        # rides in as a runtime scalar
        ns = seg_bucket(count)
        env[ROW_SEG_KEY] = to_device(seg_ids, device).to(torch.int32)
        env[SEG_SLOTS_KEY] = torch.arange(ns, dtype=torch.int32, device=device)
        env[SEG_COUNT_KEY] = torch.tensor(count, dtype=torch.int32, device=device)
    ds: dict[str, dict[str, Any]] = {}
    for p in walk_plan(plan):
        if isinstance(p, Join) and p.dim_key in db.get(p.dim_table, ()):
            ds[p.dim_table] = db.dimsort(p.dim_table, p.dim_key)
    if ds:
        env[DIMSORT_KEY] = ds
    return env


@dataclass
class CompiledPlan:
    """Reusable compiled artifact for one physical plan: the lowered
    :class:`~repro_torch.exec.stages.StageGraph` (pure stages on the device,
    host stages on the host). ``pins`` keeps identity-hashed plan
    components alive while this entry can be looked up."""

    fingerprint: str
    graph: StageGraph
    pins: list = field(default_factory=list)

    @property
    def stages(self) -> list:
        return self.graph.stages

    @property
    def is_pure(self) -> bool:
        """One pure stage, no host boundary (MLtoSQL/MLtoDNN output)."""
        return self.graph.is_pure

    @property
    def traces(self) -> int:
        """Stage specializations of this plan (captures on the card)."""
        return self.graph.traces

    @property
    def specializations(self) -> int:
        """Distinct per-stage bucket structures this plan holds, however
        they arrived (made live, or from the artifact store): ``traces``
        alone undercounts warm coverage when the store preloaded buckets."""
        return sum(st.traces + st.disk_loads for st in self.graph.stages
                   if st.kind == "pure")

    def graph_state(self) -> tuple[int, int]:
        """The graphs this plan's stages hold in the capture cache, and
        those the cache dropped to stay at its capacity (0 and 0 on the
        CPU, which captures nothing)."""
        held = evicted = 0
        for stage in self.graph.stages:
            if stage.runner is not None:
                h, e = capture.owned(stage.runner.serial)
                held, evicted = held + h, evicted + e
        return held, evicted

    def warm_start(self, store: Optional[Any] = None, database=None) -> int:
        """Preload every bucket structure the artifact store holds for this
        plan's stages; returns how many were loaded.

        With ``database`` on the card (an uploaded :class:`Database`), each
        structure's env is rebuilt on it and its graph captured now, off
        the request path, so the first request of a previously served
        bucket only replays. Otherwise (the CPU, or no database) each
        structure is marked resolved: its first call on the CPU counts no
        specialization, as the reference's deserialized programs trace
        nothing; on the card that call captures, and counts the trace. A
        structure whose resident tables do not match ``database`` is
        skipped as a miss."""
        store = store if store is not None else get_artifact_store()
        if store is None:
            return 0
        if database is not None and database.device.type == "cuda":
            place_programs(self.graph.plan, database.device)
        return sum(stage.runner.preload(store, self.graph.plan, database)
                   for stage in self.graph.stages if stage.runner is not None)

    def release(self) -> None:
        """Drop the graphs this plan's stages captured now, not when the
        stages are collected."""
        for stage in self.graph.stages:
            if stage.runner is not None:
                capture.release(stage.runner.serial)

    def _prepare(self, database, device, row_valid, params, segments, donate):
        dev = resolve_device(device)
        place_programs(self.graph.plan, dev)
        env = build_env(self.graph.plan, database, dev, row_valid, params, segments)
        # a table uploaded for this call only is single-use, as a donated one
        fresh = database.replaced if isinstance(database, Database) else frozenset()
        return env, frozenset(donate) | fresh

    def run(
        self,
        database: dict,
        row_valid=None,
        params: Optional[dict[str, Any]] = None,
        segments: Optional[tuple[np.ndarray, int]] = None,
        device=None,
        *,
        bucketer: Optional[Callable[[int], int]] = None,
        on_mid_bucket: Optional[Callable[[int, int], None]] = None,
        donate: frozenset = frozenset(),
    ) -> RunResult:
        """Execute the stage graph on ``device`` (default ``"cuda"``; raises
        when no card is available and the CPU was not asked for).

        ``database`` holds numpy arrays or tensors; numpy tables are
        uploaded (64-bit demoted) for this run, so a caller serving many
        requests uploads once with :func:`upload_database` (on the card a
        database uploaded anew is read where it lies, by graphs of its own).
        ``segments=(seg_ids, n_requests)`` threads per-row request-segment
        ids through the graph, so aggregates fold per request. ``bucketer``
        re-pads host-boundary outputs to shape buckets so post-UDF stages
        stay on captured graphs; ``donate`` names tables whose buffers are
        single-use (the serving layer's padded fact spine): a graph copies
        them into buffers of its own on every replay.
        """
        env, donate = self._prepare(database, device, row_valid, params, segments, donate)
        return run_graph(self.graph, env, bucketer=bucketer,
                         on_mid_bucket=on_mid_bucket, donate=donate)

    def run_async(
        self,
        database: dict,
        *,
        executor: Any,
        row_valid=None,
        params: Optional[dict[str, Any]] = None,
        segments: Optional[tuple[np.ndarray, int]] = None,
        device=None,
        bucketer: Optional[Callable[[int], int]] = None,
        on_mid_bucket: Optional[Callable[[int, int], None]] = None,
        donate: frozenset = frozenset(),
    ):
        """Pipelined execution: returns a ``Future[RunResult]``. Pure
        stages are enqueued on the card from the calling thread and host
        boundaries run on ``executor``'s boundary pool
        (:class:`repro_torch.exec.pipeline.PipelineExecutor`); the same
        graphs over the same env structure as :meth:`run`, so a bucket
        warmed by either path is warm for both."""
        env, donate = self._prepare(database, device, row_valid, params, segments, donate)
        return executor.run_graph_async(
            self.graph, env, bucketer=bucketer, on_mid_bucket=on_mid_bucket,
            donate=donate,
        )

    def __call__(self, database: dict, row_valid=None, params=None,
                 device=None) -> Table:
        return self.run(database, row_valid=row_valid, params=params,
                        device=device).table


class _StageRunner:
    """A pure stage's executable: eager on the CPU, captured on the card,
    with the artifact store's disk tier under both.

    On the card each key (the env's structure, shapes, dtypes and device;
    :func:`repro_torch.exec.capture.env_key`) gets one CUDA graph, captured
    on the key's first call and replayed after; each capture counts as a
    trace, as a ``jax.jit`` trace does. On the CPU the stage runs eagerly
    and each new key counts one trace, so the CPU tests hold the counts
    against the reference's. Under :func:`capture.disabled` the stage runs
    eagerly and counts nothing. The reference's fault sites are here:
    ``"latency"`` and ``"stage"`` on every call, ``"compile"`` where a
    specialization is made.

    With an artifact store active, the first call of each key computes its
    bucket structure's digest (:func:`~repro_torch.exec.artifact_store.env_digest`,
    the store's key) and consults the store under the stage's chained
    fingerprint. A miss specializes live and hands the structure to the
    store's writer thread, so the next process starts warm. On the CPU a
    stored structure makes the specialization a disk load (``disk_loads``,
    ``disk_hits``), not a trace, as the reference's deserialized programs.
    On the card a structure saves work only when :meth:`preload` captured
    its graph before the request: found at call time, the graph is captured
    on the request path and counts as the trace it is. The per-digest
    outcome is memoized: ``"live"`` (made here), ``"stored"`` (loaded, not
    yet specialized) or ``"disk"`` (specialized from the store).
    """

    def __init__(self, stage):
        self.stage = stage
        self.serial = capture.new_owner(self)
        self._seen: set = set()  # keys run on the CPU
        self._resolved: set = set()  # keys whose digest was looked up
        self._known: dict[str, str] = {}  # env digest -> its outcome
        self._lock = threading.Lock()

    def _trace(self) -> None:
        fp = self.stage.fingerprint
        maybe_inject("compile", token=fp)
        with _STATS_LOCK:
            self.stage.traces += 1
            PLAN_CACHE_STATS.traces += 1
            PLAN_CACHE_STATS.stage_traces[fp] = PLAN_CACHE_STATS.stage_traces.get(fp, 0) + 1

    def _disk_load(self) -> None:
        with _STATS_LOCK:
            self.stage.disk_loads += 1
            PLAN_CACHE_STATS.disk_hits += 1

    def __call__(self, env: dict, donate: frozenset = frozenset()):
        stage = self.stage
        # fault sites: "latency" stalls the stage, "stage" raises at call
        # time; tokens carry the stage fingerprint
        maybe_inject("latency", token=stage.fingerprint)
        maybe_inject("stage", token=stage.fingerprint)
        if not capture.enabled():
            return stage.fn(env)
        key = capture.env_key(env)
        store = get_artifact_store()
        if store is None or not stage.content_stable:
            # an identity-hashed fingerprint means nothing in another
            # process (and a recycled id could alias another stage), so an
            # unstable stage never touches the disk tier
            return self._run(env, key, donate)
        with self._lock:
            resolved = key in self._resolved
        if resolved:
            return self._run(env, key, donate)
        digest = env_digest(env)
        cuda = env_device(env).type == "cuda"
        with self._lock:
            known = self._known.get(digest)
        if known is None:
            if store.load_stage(stage.fingerprint, digest) is None:
                with self._lock:
                    self._known[digest] = "live"
                    self._resolved.add(key)
                with _STATS_LOCK:
                    PLAN_CACHE_STATS.disk_misses += 1
                out = self._run(env, key, donate)
                store.save_stage_async(stage.fingerprint, digest, env,
                                       _volatile(env, donate))
                return out
            if cuda:
                # not preloaded: the capture happens here, on the request
                # path, and saves nothing
                with self._lock:
                    self._known[digest] = "live"
                    self._resolved.add(key)
                return self._run(env, key, donate)
            self._disk_load()
            known = "stored"
        with self._lock:
            self._resolved.add(key)
            if known == "stored":
                self._known[digest] = "disk"
        # a structure marked without a card database (warm_start(database=
        # None)) is captured here all the same, and counted
        return self._run(env, key, donate, quiet=known == "stored" and not cuda)

    def _run(self, env: dict, key: tuple, donate: frozenset, quiet: bool = False):
        """Run (or capture and replay) the stage for ``env`` (its
        :func:`capture.env_key` ``key``); a new key counts a trace unless
        ``quiet`` (a specialization from the store)."""
        stage = self.stage
        device = env_device(env)
        if device.type != "cuda":
            with self._lock:
                new = key not in self._seen
                self._seen.add(key)
            if new and not quiet:
                try:
                    self._trace()
                except BaseException:
                    with self._lock:
                        self._seen.discard(key)
                    raise
            return stage.fn(env)
        volatile = frozenset(VOLATILE_KEYS) | frozenset(donate)
        gkey = (self.serial, key, capture.resident_key(env, stage.reads, volatile))
        graph, fresh = capture.lookup(gkey), False
        if graph is None:
            with capture.CAPTURE_LOCK:
                graph = capture.lookup(gkey)
                if graph is None:
                    if not quiet:
                        self._trace()
                    graph = capture.StageCapture(stage, env, volatile, device)
                    capture.insert(gkey, graph)
                    fresh = True
        state, copies = graph.replay(env, fresh=fresh)
        with _STATS_LOCK:
            PLAN_CACHE_STATS.replays += 1
            PLAN_CACHE_STATS.capture_input_copies += copies
        return state

    def preload(self, store, plan: PhysicalPlan, database=None) -> int:
        """Load every stored bucket structure of this stage this process
        has not resolved yet (see :meth:`CompiledPlan.warm_start`); returns
        how many were loaded."""
        stage = self.stage
        if not stage.content_stable:
            return 0
        n = 0
        for digest in store.stage_digests(stage.fingerprint):
            with self._lock:
                if digest in self._known:
                    # already resolved here, including structures this
                    # process specialized live and saved itself: loading
                    # those would count a disk warm start for work that
                    # never crossed a process boundary
                    continue
            stored = store.load_stage(stage.fingerprint, digest)
            if stored is None:
                continue
            if database is None or database.device.type != "cuda":
                with self._lock:
                    self._known[digest] = "stored"
            else:
                env = _stored_env(stored, plan, database)
                if env is None or env_digest(env) != digest:
                    with _STATS_LOCK:
                        PLAN_CACHE_STATS.disk_misses += 1
                    continue
                key = capture.env_key(env)
                donated = frozenset(k for k in stored.volatile if k not in VOLATILE_KEYS)
                self._run(env, key, donated, quiet=True)
                with self._lock:
                    self._known[digest] = "disk"
                    self._resolved.add(key)
            self._disk_load()
            n += 1
        return n


def _volatile(env: dict, donate: frozenset) -> frozenset:
    """The per-call keys of an env: ``VOLATILE_KEYS`` and donated tables."""
    return frozenset(k for k in env if k in VOLATILE_KEYS or k in donate)


def _zeros(spec, device):
    """A zero-filled tree of tensors for an abstract (sub)env."""
    if isinstance(spec, TensorSpec):
        return torch.zeros(spec.shape, dtype=getattr(torch, spec.dtype), device=device)
    if isinstance(spec, dict):
        return {k: _zeros(v, device) for k, v in spec.items()}
    raise ValueError(f"no per-call value for a {spec!r} leaf")


def _stored_env(stored, plan: PhysicalPlan, database) -> Optional[dict]:
    """A stored bucket's env on ``database``: its per-call keys zero-filled
    at their stored shapes, its resident tables and dim sorts the
    database's own (the tensors a request reads, so the graph captured for
    it is the one the request replays); None where the database lacks a
    table it names."""
    base = build_env(plan, database, database.device, None, None, None)
    env: dict[str, Any] = {}
    for k, spec in stored.structure.items():
        if k in stored.volatile:
            env[k] = _zeros(spec, database.device)
        elif k in base:
            env[k] = base[k]
        else:
            return None
    return env


def _build_compiled(plan: PhysicalPlan, fingerprint: str, pins: list,
                    kernels: Optional[bool]) -> CompiledPlan:
    graph = build_stage_graph(plan, pins=pins, kernels=kernels)
    for stage in graph.stages:
        if stage.kind == "pure":
            stage.runner = _StageRunner(stage)
    return CompiledPlan(fingerprint=fingerprint, graph=graph, pins=pins)


def compile_plan(plan: PhysicalPlan, cache: bool = True,
                 kernels: Optional[bool] = None) -> CompiledPlan:
    """Compile a plan into a reusable executable over a database dict.

    Compiled plans are cached in a module-level LRU keyed by plan
    fingerprint, so repeated compile/execute of an identical plan reuses the
    lowered stages. ``cache=False`` forces a fresh compile. ``kernels``
    sets the relational-kernel mode of this compile alone (``False``: Join
    and Aggregate run the torch composition, not ``gather_join`` /
    ``segment_agg``); None reads the ``RAVEN_KERNELS`` knob.
    """
    pins: list = []
    fp = plan_fingerprint(plan, pins=pins, kernels=kernels)
    if not cache:
        return _build_compiled(plan, fp, pins, kernels)
    entry = _PLAN_CACHE.get(fp)
    if entry is not None:
        PLAN_CACHE_STATS.hits += 1
        _PLAN_CACHE.pop(fp)  # LRU: re-insert as most recent
        _PLAN_CACHE[fp] = entry
        return entry
    PLAN_CACHE_STATS.misses += 1
    entry = _build_compiled(plan, fp, pins, kernels)
    _PLAN_CACHE[fp] = entry
    while len(_PLAN_CACHE) > PLAN_CACHE_CAPACITY:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        PLAN_CACHE_STATS.evictions += 1
    return entry


def execute_plan(
    plan: PhysicalPlan,
    database: dict,
    row_valid=None,
    params: Optional[dict[str, Any]] = None,
    device=None,
) -> Table:
    """One-shot: compile (cached) and run ``plan`` on ``device`` (default
    ``"cuda"``)."""
    return compile_plan(plan)(
        database, row_valid=row_valid, params=params, device=device
    )


def plan_params(plan: PhysicalPlan) -> set[str]:
    """Names of every :class:`~repro_torch.relational.expr.Param` the plan
    reads."""
    from repro_torch.relational.expr import params_of

    names: set[str] = set()
    for p in walk_plan(plan):
        if isinstance(p, Filter):
            names |= params_of(p.expr)
        elif isinstance(p, Project):
            for e in p.exprs.values():
                names |= params_of(e)
    return names


# ---------------------------------------------------------------------------
# Data-parallel execution over a mesh axis
# ---------------------------------------------------------------------------

SHARD_COUNT = "__shard_count__"  # the hidden count a sharded MIN/MAX reads


def compile_plan_sharded(plan: PhysicalPlan, mesh, fact_table: str,
                         axis: str = "data") -> Callable[[dict], Table]:
    """Shard the fact table's rows over ``mesh``'s ``axis``; every other
    table whole on every rank. Returns ``run(database) -> Table``, to be
    called on every rank of the axis.

    Only for a plan whose stage graph is one pure stage (MLtoSQL / MLtoDNN
    output). Each rank runs the plan, compiled as :func:`compile_plan`
    compiles it, on its contiguous slice of the fact table's rows (the
    kernels run there as they do unsharded), then:

    * an aggregate at the plan's root reduces over the axis's group: COUNT
      and SUM by a SUM all-reduce (the reference's ``psum``); MIN and MAX by
      MIN and MAX all-reduces, a shard without a valid row counting as
      ±inf and a NaN in any shard giving NaN (a flag reduced beside the
      value: gloo's MIN keeps or drops a NaN by the ranks' order), so that
      they equal the unsharded plan's, 0.0 where no row is valid at all.
      MEAN is refused: ask for SUM and COUNT and divide (the reference's
      ``psum`` of a mean, a min or a max is |axis| times the answer);
    * a plan without an aggregate all-gathers each output column and
      ``valid`` in rank order, so every rank holds the global Table.

    A fact table whose rows do not split evenly over the axis is refused,
    as ``shard_map`` refuses it. The output columns come in the stage's
    ``out_columns`` order (the reference's ``_out_cols``), the same on
    every rank, so the ranks make the same collectives in the same order.
    The plan runs on the mesh's device: the card (NCCL) or the CPU (gloo).
    """
    graph = build_stage_graph(plan)
    if not (len(graph.stages) == 1 and graph.is_pure):
        raise ValueError("sharded execution requires a host-boundary-free plan; its stages are "
                         f"{[s.kind for s in graph.stages]}")
    aggs = list(plan.aggs) if isinstance(plan, Aggregate) else None
    if aggs is None and graph.has_aggregate:
        raise ValueError("sharded execution reduces an aggregate at the plan's root only")
    if aggs is not None:
        means = [name for name, op, _ in aggs if op == "mean"]
        if means:
            raise ValueError(f"a sharded plan cannot reduce the mean {means}: ask for SUM and "
                             "COUNT and divide")
        if any(op in ("min", "max") for _, op, _ in aggs):
            plan = Aggregate(plan.child, [*aggs, (SHARD_COUNT, "count", aggs[0][2])])
    compiled = compile_plan(plan)
    out_cols = list(graph.stages[0].out_columns)
    dev = resolve_device(mesh.device_type)
    k, r = axis_size(mesh, axis), axis_index(mesh, axis)
    group = axis_group(mesh, axis)

    def run(database) -> Table:
        fact = database[fact_table]
        n = int(next(iter(fact.values())).shape[0])
        if n % k:
            raise ValueError(f"{fact_table!r} has {n} rows, which do not split over the {k} "
                             f"ranks of axis {axis!r}")
        cols = {c: v[r * n // k:(r + 1) * n // k] for c, v in fact.items()}
        if isinstance(database, Database) and database.device == dev:
            local = database.replace(fact_table, cols)
        else:
            local = upload_database({**database, fact_table: cols}, dev)
        table = compiled(local, device=dev)
        if aggs is None:
            return Table({c: all_gather_rows(table.columns[c], mesh, (axis,)) for c in out_cols},
                         all_gather_rows(table.valid, mesh, (axis,)))
        return Table(_reduce_aggregates(table.columns, aggs, group), table.valid)

    return run


def _reduce_aggregates(cols: dict, aggs: list, group) -> dict:
    """One rank's global fold reduced over ``group`` in two collectives
    (see :func:`compile_plan_sharded`): a SUM all-reduce of the COUNTs and
    SUMs, with the hidden row count and the extremes' NaN flags beside
    them, and a MIN all-reduce of the MINs and the negated MAXs (negation
    is exact)."""
    import torch.distributed as dist

    def all_reduce(parts: list, op) -> list:
        flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
        dist.all_reduce(flat, op=op, group=group)
        return list(flat.split([p.numel() for p in parts]))

    sums = [name for name, op, _ in aggs if op in ("count", "sum")]
    ext = [(name, 1.0 if op == "min" else -1.0) for name, op, _ in aggs
           if op in ("min", "max")]
    parts = [cols[n] for n in sums]
    if ext:
        parts += [cols[SHARD_COUNT]] + [torch.isnan(cols[n]) for n, _ in ext]
    summed = all_reduce(parts, dist.ReduceOp.SUM)
    out = {name: v.to(cols[name].dtype) for name, v in zip(sums, summed)}
    if ext:
        total, nans = summed[len(sums)], summed[len(sums) + 1:]
        mine = cols[SHARD_COUNT] > 0  # a shard without a valid row: +inf, ignored
        least = all_reduce([torch.where(mine, sign * cols[n], float("inf")) for n, sign in ext],
                           dist.ReduceOp.MIN)
        for (name, sign), v, nan in zip(ext, least, nans):
            v = torch.where(total > 0, sign * v, 0.0)
            out[name] = torch.where(nan > 0, float("nan"), v).to(cols[name].dtype)
    return {name: out[name] for name, _, _ in aggs}
