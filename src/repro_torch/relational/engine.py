"""Physical plans + execution for the columnar PyTorch data engine.

A plan is a tree of operators over a database (dict of named column-dicts).
Lowering turns it into a :class:`~repro_torch.exec.stages.StageGraph` of
pure stages that run eagerly on the plan's device — the card unless the
caller asks for the CPU. This module owns the plan-node definitions, the
host→device upload with its baked dim-table sorts, and the
fingerprint-keyed compiled-plan cache on top of the stage graph.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
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
    """Host-boundary pipeline invocation (interpreted 'ML runtime'). The
    node exists so plans keep the reference's shape; executing it is not
    ported yet (see ``exec.stages.HOST_BOUNDARY_ITEM``)."""

    child: "PhysicalPlan"
    pipeline: Any  # TrainedPipeline
    output_names: list[str]  # graph outputs -> column names
    batch_size: int = 10_000
    consumes: tuple[str, ...] = ()


@dataclass
class TensorOp:
    """Fused tensor program (MLtoDNN output): ``fn(cols) -> cols``, an
    ``nn.Module`` whose buffers the engine moves to the run's device."""

    child: "PhysicalPlan"
    fn: Callable[[dict[str, torch.Tensor]], dict[str, torch.Tensor]]
    output_names: list[str]
    # upstream block columns this node is the last consumer of (split)
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
    RunResult,
    StageGraph,
    build_stage_graph,
    run_graph,
    seg_bucket,
)


def plan_fingerprint(plan: PhysicalPlan, pins: Optional[list] = None) -> str:
    """Canonical content hash of a physical plan.

    Structurally identical plans hash equal. Opaque callables hash by
    identity and are reported via ``pins``; the compiled-plan cache keeps
    those alive so a fingerprint can never alias a dead closure's recycled
    id. Plans containing Join/Aggregate ops additionally fold in the
    ``RAVEN_KERNELS`` mode token, so a plan cached under one mode is never
    served under the other.
    """
    from repro_torch.core.fingerprint import fingerprint
    from repro_torch.kernels.ops import kernel_mode_token

    extra = (
        [kernel_mode_token()]
        if any(isinstance(p, (Join, Aggregate)) for p in walk_plan(plan))
        else []
    )
    return fingerprint(plan, *extra, pins=pins)


@dataclass
class CacheStats:
    """Module-level compiled-plan cache accounting. (The reference also
    counts XLA traces; eager PyTorch has none to count.)"""

    hits: int = 0
    misses: int = 0
    evictions: int = 0

    def snapshot(self) -> dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


PLAN_CACHE_STATS = CacheStats()
_PLAN_CACHE: "dict[str, CompiledPlan]" = {}  # insertion-ordered: LRU via re-insert
PLAN_CACHE_CAPACITY = 64


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    PLAN_CACHE_STATS.hits = PLAN_CACHE_STATS.misses = 0
    PLAN_CACHE_STATS.evictions = 0


# -- the uploaded database and its baked dim-table sort orders ---------------
# Dim tables are frozen at registration, so a Join's sorted key order is
# computed once per uploaded database, on the host, from the host copy of
# the keys the upload kept: a request never copies device memory back to the
# host to learn the order. Entries carry a zero-length "unique" marker when
# the keys are duplicate-free: that is what lets the Join step use the
# gather-join kernel.


def dimsort_entry(keys: np.ndarray, device) -> dict[str, torch.Tensor]:
    """Baked sort data for one host dim-key column, on ``device``: the keys
    sorted, the stable argsort permutation (int32), and the uniqueness
    marker."""
    nk = np.ascontiguousarray(keys)
    order = np.argsort(nk, kind="stable")
    sk = nk[order]
    entry = {
        "keys": torch.from_numpy(sk).to(device),
        "order": torch.from_numpy(order.astype(np.int32)).to(device),
    }
    if sk.size == 0 or not np.any(sk[1:] == sk[:-1]):
        entry["unique"] = torch.zeros((0,), dtype=torch.int32, device=device)
    return entry


class Database(dict):
    """Tables on one device (table -> column -> tensor), as
    :func:`upload_database` returns them. It keeps the host copy of every
    integer column it uploaded from numpy and each Join key's baked sort,
    computed on first use."""

    def __init__(self, tables: dict, device: torch.device, host: dict):
        super().__init__(tables)
        self.device = device
        self._host = host  # (table, column) -> host copy of an integer column
        self._sorts: dict[tuple[str, str], dict[str, torch.Tensor]] = {}

    def dimsort(self, table: str, column: str) -> dict[str, torch.Tensor]:
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


@dataclass
class CompiledPlan:
    """Reusable compiled artifact for one physical plan: the lowered
    :class:`~repro_torch.exec.stages.StageGraph`. ``pins`` keeps
    identity-hashed plan components alive while this entry can be looked
    up."""

    fingerprint: str
    graph: StageGraph
    pins: list = field(default_factory=list)
    device: Optional[torch.device] = None  # where the TensorOp programs sit

    @property
    def stages(self) -> list:
        return self.graph.stages

    def _place(self, device: torch.device) -> None:
        """Move every TensorOp program to ``device`` (once per device)."""
        if self.device == device:
            return
        for p in walk_plan(self.graph.plan):
            if isinstance(p, TensorOp) and isinstance(p.fn, torch.nn.Module):
                p.fn.to(device)
        self.device = device

    def _env(
        self,
        database: dict,
        device: torch.device,
        row_valid,
        params: Optional[dict[str, Any]],
        segments: Optional[tuple[np.ndarray, int]],
    ) -> dict[str, Any]:
        """Build the execution environment on ``device``."""
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
        ds: dict[str, dict[str, torch.Tensor]] = {}
        for p in walk_plan(self.graph.plan):
            if isinstance(p, Join) and p.dim_key in db.get(p.dim_table, ()):
                ds[p.dim_table] = db.dimsort(p.dim_table, p.dim_key)
        if ds:
            env[DIMSORT_KEY] = ds
        return env

    def run(
        self,
        database: dict,
        row_valid=None,
        params: Optional[dict[str, Any]] = None,
        segments: Optional[tuple[np.ndarray, int]] = None,
        device=None,
    ) -> RunResult:
        """Execute the stage graph on ``device`` (default ``"cuda"``; raises
        when no card is available and the CPU was not asked for).

        ``database`` holds numpy arrays or tensors; numpy tables are
        uploaded (64-bit demoted) for this run, so a caller serving many
        requests uploads once with :func:`upload_database`.
        ``segments=(seg_ids, n_requests)`` threads per-row request-segment
        ids through the graph, so aggregates fold per request.
        """
        dev = resolve_device(device)
        self._place(dev)
        env = self._env(database, dev, row_valid, params, segments)
        return run_graph(self.graph, env)

    def __call__(self, database: dict, row_valid=None, params=None,
                 device=None) -> Table:
        return self.run(database, row_valid=row_valid, params=params,
                        device=device).table


def _build_compiled(plan: PhysicalPlan, fingerprint: str, pins: list) -> CompiledPlan:
    return CompiledPlan(
        fingerprint=fingerprint, graph=build_stage_graph(plan, pins=pins),
        pins=pins,
    )


def compile_plan(plan: PhysicalPlan, cache: bool = True) -> CompiledPlan:
    """Compile a plan into a reusable executable over a database dict.

    Compiled plans are cached in a module-level LRU keyed by plan
    fingerprint, so repeated compile/execute of an identical plan reuses the
    lowered stages. ``cache=False`` forces a fresh compile.
    """
    pins: list = []
    fp = plan_fingerprint(plan, pins=pins)
    if not cache:
        return _build_compiled(plan, fp, pins)
    entry = _PLAN_CACHE.get(fp)
    if entry is not None:
        PLAN_CACHE_STATS.hits += 1
        _PLAN_CACHE.pop(fp)  # LRU: re-insert as most recent
        _PLAN_CACHE[fp] = entry
        return entry
    PLAN_CACHE_STATS.misses += 1
    entry = _build_compiled(plan, fp, pins)
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

