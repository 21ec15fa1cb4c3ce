"""Persistent plan-artifact store: warm-start serving across processes.

Raven's premise is optimize once, serve many times, and "once" should not
mean once per process. The StageGraph's chained per-stage content
fingerprints (``repro_torch.core.fingerprint.node_fingerprint``) are stable
across processes, so they key durable artifacts. This module is that disk
tier, with two layers:

  * **plan layer** — the optimizer's output ``(PhysicalPlan,
    OptimizationReport)`` pickled per *query* fingerprint (IR plan + stats +
    optimizer configuration), so ``Query.prepare()`` in a fresh session
    skips re-optimization when nothing it depends on changed. Plans whose
    content is not cross-process stable are skipped: identity-hashed
    components, and every plan holding a ``TensorOp`` program (an
    ``nn.Module`` that may hold tensors on the card; the reference's
    pickler refuses its programs' closures, so the two persist the same
    plans). The stage layer still covers them: their programs carry
    canonical ``__fingerprint_token__`` s.
  * **stage layer** — a CUDA graph cannot be serialised, so an entry holds
    the *structure* of one bucket of a pure stage, not an executable: the
    env's nesting with every leaf's shape and dtype, and which of its keys
    are per-call (``exec/stages.py`` ``VOLATILE_KEYS`` and the run's
    donated tables). It holds no value and no device. The key is (chained
    stage fingerprint, :func:`env_digest`). A later process rebuilds that
    env on its own database, per-call leaves zero-filled, and captures the
    stage's graph for it at registration, before the first request
    (``CompiledPlan.warm_start``); on the CPU, which captures nothing, the
    bucket is marked resolved, so its first call counts no specialization.

Every entry is one directory written with the same atomic discipline as a
checkpoint (tmp dir + ``os.rename``; ``meta.json`` written last marks the
entry complete), so concurrent writers never clobber each other and a
crash mid-write never corrupts the store. Loads verify a compatibility
header (store version, torch and CUDA versions, the device's capability,
the kernel library's source digest) and fall back to live work on any
mismatch, truncation, or corruption: a bad cache can cost time, never
correctness. ``max_entries`` and ``max_bytes`` bound the directory via
oldest-first eviction.
"""
from __future__ import annotations

import atexit
import hashlib
import json
import os
import pickle
import queue
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.exec.stages import DIMSORT_CACHE, DIMSORT_KEY

STORE_VERSION = 1

_PLANS = "plans"
_STAGES = "stages"
_REGISTRY = "registry"
_META = "meta.json"
_PLAN_BLOB = "plan.pkl"
_STAGE_BLOB = "structure.json"
_TENSOR = "__tensor__"  # the JSON tag of one leaf's (shape, dtype)
_SCALAR = "__scalar__"  # the JSON tag of one non-tensor leaf's type


class TensorSpec(NamedTuple):
    """One leaf of an abstract env: a tensor's shape and dtype name."""

    shape: tuple
    dtype: str


class ScalarSpec(NamedTuple):
    """One non-tensor leaf of an abstract env: its type's name."""

    type: str


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _abstract(x, path: tuple):
    if isinstance(x, (TensorSpec, ScalarSpec)):
        return x
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return TensorSpec(tuple(int(d) for d in x.shape), _dtype_name(x))
    if isinstance(x, dict):
        return {k: _abstract(v, path + (k,)) for k, v in x.items()
                if not _is_cache(path, k)}
    return ScalarSpec(type(x).__name__)  # its type, never its value


def _is_cache(path: tuple, key) -> bool:
    """A dim sort's payload cache: built on first use, not an input."""
    return len(path) == 2 and path[0] == DIMSORT_KEY and key == DIMSORT_CACHE


def abstract_env(env: dict[str, Any]) -> dict[str, Any]:
    """Reduce an execution environment to its structure: every tensor (or
    numpy array) becomes a :class:`TensorSpec` (already-abstract leaves pass
    through), every other leaf a :class:`ScalarSpec`; a dim sort's payload cache
    is left out. The engine takes it as soon as a new structure is seen, so
    the store's background writer never pins a tensor on the card."""
    return _abstract(env, ())


def env_digest(env: dict[str, Any]) -> str:
    """Canonical digest of an execution environment's *structure*: the key
    paths (table/column names, special keys) with every leaf's shape and
    dtype, concrete or abstract alike. Values are excluded: the same bucket
    shape maps onto the same entry whatever rows arrive in it."""
    h = hashlib.sha256()

    def walk(x, path: tuple) -> None:
        if isinstance(x, dict):
            h.update(b"{")
            for k in sorted(x):
                if not _is_cache(path, k):
                    h.update(f"{k!r}:".encode())
                    walk(x[k], path + (k,))
            h.update(b"}")
            return
        leaf = _abstract(x, path)
        h.update(f"{leaf!r};".encode())

    walk(env, ())
    return h.hexdigest()[:32]


def _encode(tree):
    if isinstance(tree, TensorSpec):
        return {_TENSOR: [list(tree.shape), tree.dtype]}
    if isinstance(tree, ScalarSpec):
        return {_SCALAR: tree.type}
    if isinstance(tree, dict):
        return {k: _encode(v) for k, v in tree.items()}
    return tree


def _decode(tree):
    if isinstance(tree, dict):
        if set(tree) == {_TENSOR}:
            shape, dtype = tree[_TENSOR]
            return TensorSpec(tuple(shape), dtype)
        if set(tree) == {_SCALAR}:
            return ScalarSpec(tree[_SCALAR])
        return {k: _decode(v) for k, v in tree.items()}
    return tree


def device_capability(device=None) -> str:
    """``sm_XY`` of a card (``sm_90`` on an H100), ``cpu`` on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    major, minor = torch.cuda.get_device_capability(dev)
    return f"sm_{major}{minor}"


def compat_header(device=None) -> dict[str, Any]:
    """The environment an artifact is only valid in: store version, torch
    and CUDA versions, the device's capability and the kernels' sources."""
    from repro_torch.kernels import _build

    return {
        "store_version": STORE_VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": device_capability(device),
        "kernels": _build._digest(),
    }


@dataclass(frozen=True)
class StoredStage:
    """One stage-layer entry: the bucket's abstract env and its per-call
    keys (``VOLATILE_KEYS`` present and the run's donated tables)."""

    structure: dict
    volatile: frozenset


@dataclass
class StoreStats:
    """Disk-tier accounting (surfaced via ``db.cache_stats()``)."""

    plan_hits: int = 0
    plan_misses: int = 0
    plan_saves: int = 0
    stage_hits: int = 0
    stage_misses: int = 0
    stage_saves: int = 0
    incompatible: int = 0  # the compatibility header rejected an entry
    corrupt: int = 0       # truncated/unreadable entry quarantined
    skipped: int = 0       # content not cross-process stable; not persisted
    save_errors: int = 0
    evictions: int = 0
    background_writes: int = 0  # stage structures handed to the writer thread
    fallbacks: int = 0     # loads that fell back to live work because the
                           # entry was corrupt/incompatible (not plain
                           # misses) — the serving-visible degradation count
    registry_saves: int = 0  # registry-journal writes (crash-safe recovery)
    registry_loads: int = 0
    registry_skipped: int = 0  # journal writes dropped (unpicklable state) —
                               # the on-disk journal is stale from here on

    def snapshot(self) -> dict[str, int]:
        return dict(self.__dict__)


class ArtifactStore:
    """Content-addressed disk cache for optimizer output and stage
    structures.

    Keys are caller-supplied canonical fingerprints (query fingerprint for
    the plan layer; chained stage fingerprint + env digest for the stage
    layer). All loads are fail-soft: any problem returns ``None`` and the
    caller works live. ``device`` is the device whose capability the
    compatibility header names: the card unless the caller passes
    ``device="cpu"``.
    """

    def __init__(
        self,
        root: str,
        *,
        max_entries: int = 512,
        max_bytes: Optional[int] = None,
        device=None,
    ):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.max_entries = int(max_entries)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self.device = resolve_device(device)
        self.header = compat_header(self.device)
        self.stats = StoreStats()
        self._write_queue: Optional[queue.Queue] = None
        self._writer: Optional[threading.Thread] = None
        self._writer_lock = threading.Lock()
        os.makedirs(os.path.join(self.root, _PLANS), exist_ok=True)
        os.makedirs(os.path.join(self.root, _STAGES), exist_ok=True)

    def __repr__(self) -> str:
        return f"ArtifactStore({self.root!r}, entries={len(self._entries())})"

    # -- plan layer ----------------------------------------------------------

    def save_plan(self, query_fp: str, plan: Any, report: Any) -> bool:
        """Persist one optimizer output under its query fingerprint.

        Returns False (without writing) when the plan's content is not
        stable across processes: identity-hashed components, a ``TensorOp``
        program, or anything the pickler refuses — a fingerprint built on
        ``id()`` must never be trusted from another process.
        """
        from repro_torch.relational.engine import TensorOp, plan_fingerprint, walk_plan

        pins: list = []
        plan_fp = plan_fingerprint(plan, pins=pins)
        if pins or any(isinstance(p, TensorOp) for p in walk_plan(plan)):
            self.stats.skipped += 1
            return False
        try:
            blob = pickle.dumps((plan, report))
        except Exception:
            self.stats.skipped += 1
            return False
        meta = {**self.header, "plan_fingerprint": plan_fp}
        return self._write_entry(
            os.path.join(self.root, _PLANS, query_fp),
            {_PLAN_BLOB: blob}, meta,
        )

    def load_plan(self, query_fp: str) -> Optional[tuple[Any, Any]]:
        """Load ``(plan, report)`` for a query fingerprint, or None.

        The unpickled plan is re-fingerprinted and checked against the
        entry's recorded hash, so a corrupted blob that still unpickles is
        rejected rather than silently served.
        """
        from repro_torch.relational.engine import plan_fingerprint

        d = os.path.join(self.root, _PLANS, query_fp)
        if self._injected_read_fault(d, token=query_fp):
            self.stats.plan_misses += 1
            return None
        meta = self._read_meta(d)
        if meta is None:
            self.stats.plan_misses += 1
            return None
        if not self._compatible(meta):
            self.stats.plan_misses += 1
            return None
        try:
            with open(os.path.join(d, _PLAN_BLOB), "rb") as f:
                plan, report = pickle.loads(f.read())
            pins: list = []
            if plan_fingerprint(plan, pins=pins) != meta["plan_fingerprint"] or pins:
                raise ValueError("plan fingerprint mismatch after load")
        except FileNotFoundError:
            self._quarantine(d)  # meta without blob: a truncated entry
            self.stats.plan_misses += 1
            return None
        except OSError:
            self.stats.plan_misses += 1  # transient: retry next time
            return None
        except Exception:
            self._quarantine(d)
            self.stats.plan_misses += 1
            return None
        self.stats.plan_hits += 1
        return plan, report

    # -- stage layer ---------------------------------------------------------

    def save_stage(
        self, stage_fp: str, digest: str, env: dict[str, Any],
        volatile: frozenset = frozenset(),
    ) -> bool:
        """Persist one bucket's structure: ``env`` (concrete or abstract)
        reduced to shapes and dtypes, with its per-call keys ``volatile``."""
        try:
            blob = json.dumps({
                "structure": _encode(abstract_env(env)),
                "volatile": sorted(volatile),
            }).encode()
        except Exception:
            self.stats.save_errors += 1
            return False
        meta = {**self.header, "stage_fingerprint": stage_fp, "env_digest": digest}
        return self._write_entry(
            os.path.join(self.root, _STAGES, stage_fp, digest),
            {_STAGE_BLOB: blob}, meta,
        )

    def save_stage_async(
        self, stage_fp: str, digest: str, env: dict[str, Any],
        volatile: frozenset = frozenset(),
    ) -> None:
        """Queue one stage structure for the background writer thread.

        ``env`` is reduced to shapes/dtypes immediately (:func:`abstract_env`),
        so the queue never pins a tensor on the card. ``drain()`` blocks until
        queued writes land — registered via ``atexit`` too, so a short-lived
        process still persists what it served.
        """
        abstract = abstract_env(env)
        with self._writer_lock:
            if self._write_queue is None:
                self._write_queue = queue.Queue()
                self._writer = threading.Thread(
                    target=self._writer_loop, name="raven-artifact-writer",
                    daemon=True,
                )
                self._writer.start()
                atexit.register(self.drain)
            self.stats.background_writes += 1
            self._write_queue.put((stage_fp, digest, abstract, frozenset(volatile)))

    def _writer_loop(self) -> None:
        q = self._write_queue
        while True:
            item = q.get()
            try:
                if item is not None:
                    self.save_stage(*item)
            except BaseException:  # noqa: BLE001 — the writer must survive
                self.stats.save_errors += 1
            finally:
                q.task_done()
            if item is None:
                return

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every queued background write has been attempted.

        ``timeout`` bounds the wait (None = until the queue empties); safe
        to call from any thread, any number of times.
        """
        with self._writer_lock:
            q = self._write_queue
        if q is None:
            return
        if timeout is None:
            q.join()
            return
        # poll with a deadline instead of spawning a joiner thread: a stuck
        # write must not leak one permanently-parked thread per timed call
        end = time.monotonic() + timeout
        while q.unfinished_tasks and time.monotonic() < end:
            time.sleep(0.01)

    def close(self) -> None:
        """Flush pending writes, stop the writer thread, and drop the
        ``atexit`` hook, so a long-lived process that opens many stores does
        not keep one parked writer thread (and one atexit reference pinning
        the store) per store. A closed store stays usable: the next async
        save starts a fresh writer."""
        with self._writer_lock:
            q, writer = self._write_queue, self._writer
            self._write_queue = None
            self._writer = None
        if q is None:
            return
        q.put(None)  # writes ahead of the sentinel still land (FIFO)
        if writer is not None:
            writer.join(timeout=30.0)
        try:
            atexit.unregister(self.drain)
        except Exception:  # pragma: no cover - unregister is best-effort
            pass

    def pending_writes(self) -> int:
        with self._writer_lock:
            q = self._write_queue
        return 0 if q is None else q.unfinished_tasks

    def load_stage(self, stage_fp: str, digest: str) -> Optional[StoredStage]:
        """Load one stage structure, or None. The decoded structure is
        digested again and checked against the key, so a blob that parses
        but was altered is rejected."""
        d = os.path.join(self.root, _STAGES, stage_fp, digest)
        if self._injected_read_fault(d, token=stage_fp):
            self.stats.stage_misses += 1
            return None
        meta = self._read_meta(d)
        if meta is None:
            self.stats.stage_misses += 1
            return None
        if not self._compatible(meta) or meta.get("env_digest") != digest:
            self.stats.stage_misses += 1
            return None
        try:
            with open(os.path.join(d, _STAGE_BLOB), "rb") as f:
                blob = json.loads(f.read())
            stored = StoredStage(_decode(blob["structure"]),
                                 frozenset(blob["volatile"]))
            if env_digest(stored.structure) != digest:
                raise ValueError("stage structure does not match its digest")
        except FileNotFoundError:
            self._quarantine(d)  # meta without blob: a truncated entry
            self.stats.stage_misses += 1
            return None
        except OSError:
            self.stats.stage_misses += 1  # transient: retry next time
            return None
        except Exception:
            self._quarantine(d)
            self.stats.stage_misses += 1
            return None
        self.stats.stage_hits += 1
        return stored

    # -- registry-journal layer ----------------------------------------------
    # Unlike plans/stages, the journal is *mutable* state: one file per
    # registry fingerprint, rewritten whole on every lifecycle mutation.
    # ``tmp + os.replace`` keeps each rewrite atomic (a kill -9 mid-write
    # leaves the previous complete journal in place), which is what makes
    # ``Session.recover()`` crash-safe.

    def _registry_path(self, key: str) -> str:
        return os.path.join(self.root, _REGISTRY, f"{key}.pkl")

    def save_registry(self, key: str, state: Any) -> bool:
        """Atomically persist one registry journal under its fingerprint.

        Returns False without writing when the state does not pickle
        (e.g. a published pipeline closes over an unpicklable python UDF) —
        the in-process registry still works; only crash recovery is
        unavailable, and ``stats.skipped`` records it.
        """
        try:
            blob = pickle.dumps({"header": self.header, "state": state})
        except Exception:
            self.stats.skipped += 1
            self.stats.registry_skipped += 1
            return False
        d = os.path.join(self.root, _REGISTRY)
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(prefix=".journal_tmp_", dir=d)
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._registry_path(key))
        except OSError:
            self.stats.save_errors += 1
            return False
        self.stats.registry_saves += 1
        return True

    def load_registry(self, key: str) -> Optional[Any]:
        """Load the journal for one registry fingerprint, or None.

        Only the store version gates compatibility — the journal describes
        route/version *topology*, which is device-independent; the plan and
        stage artifacts it points at check their own full headers."""
        path = self._registry_path(key)
        if self._injected_read_fault(path, token=key):
            return None
        try:
            with open(path, "rb") as f:
                payload = pickle.loads(f.read())
            header, state = payload["header"], payload["state"]
        except FileNotFoundError:
            return None
        except OSError:
            return None
        except Exception:
            self.stats.corrupt += 1
            self.stats.fallbacks += 1
            try:
                os.replace(path, path + ".quarantined")
            except OSError:
                pass
            return None
        if header.get("store_version") != STORE_VERSION:
            self.stats.incompatible += 1
            self.stats.fallbacks += 1
            return None
        self.stats.registry_loads += 1
        return state

    def stage_digests(self, stage_fp: str) -> list[str]:
        """Every complete on-disk env digest for one stage fingerprint
        (registration warm-start enumerates these)."""
        d = os.path.join(self.root, _STAGES, stage_fp)
        try:
            names = os.listdir(d)
        except OSError:
            return []
        return sorted(
            n for n in names
            if os.path.exists(os.path.join(d, n, _META))
        )

    # -- internals -----------------------------------------------------------

    def _write_entry(
        self, final_dir: str, files: dict[str, bytes], meta: dict[str, Any]
    ) -> bool:
        """Atomic entry write: tmp dir + rename; meta.json written last.

        Lost races are fine — content-addressed keys mean the winner wrote
        the same artifact, so the loser just discards its tmp dir.
        """
        if os.path.exists(os.path.join(final_dir, _META)):
            return True  # already present (same content by construction)
        os.makedirs(os.path.dirname(final_dir), exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".art_tmp_", dir=self.root)
        try:
            for name, data in files.items():
                with open(os.path.join(tmp, name), "wb") as f:
                    f.write(data)
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump(meta, f)
            try:
                os.rename(tmp, final_dir)
            except OSError:
                shutil.rmtree(tmp, ignore_errors=True)  # concurrent writer won
                return True
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            self.stats.save_errors += 1
            return False
        if "plan_fingerprint" in meta:
            self.stats.plan_saves += 1
        else:
            self.stats.stage_saves += 1
        self._evict()
        return True

    def _read_meta(self, d: str) -> Optional[dict[str, Any]]:
        try:
            with open(os.path.join(d, _META)) as f:
                return json.load(f)
        except ValueError:
            # the header exists but is not valid json: the entry is truly
            # corrupt (entries are renamed into place whole, meta written
            # last), so drop it for rebuild
            self._quarantine(d)
            return None
        except OSError:
            # missing entry (a plain miss) or a transient error (EMFILE,
            # EACCES from a scanner holding the file): never delete a
            # possibly-healthy entry — just report a miss and move on
            return None

    def _injected_read_fault(self, d: str, token: str = "") -> bool:
        """The ``store-read`` fault site: when the installed
        :class:`~repro_torch.exec.faults.FaultPlan` fires here, the entry is
        treated as torn on disk — quarantined through the real corruption
        path (so the counters the serving layer surfaces are the real
        ones) — and the load reports a miss. Store reads are fail-soft by
        contract, so an injected read fault degrades to live work and can
        never surface as a caller-visible error."""
        from repro_torch.errors import FaultInjectedError
        from repro_torch.exec.faults import maybe_inject

        try:
            maybe_inject("store-read", token=token)
        except FaultInjectedError:
            if os.path.exists(os.path.join(d, _META)):
                self._quarantine(d)
            else:
                self.stats.fallbacks += 1
            return True
        return False

    def _compatible(self, meta: dict[str, Any]) -> bool:
        if all(meta.get(k) == v for k, v in self.header.items()):
            return True
        self.stats.incompatible += 1
        self.stats.fallbacks += 1
        return False

    def _quarantine(self, d: str) -> None:
        """Drop a corrupted/truncated entry so it is rebuilt, not retried."""
        self.stats.corrupt += 1
        self.stats.fallbacks += 1
        shutil.rmtree(d, ignore_errors=True)

    def _entries(self) -> list[str]:
        """Every complete entry directory (plans/* and stages/*/*)."""
        out: list[str] = []
        plans = os.path.join(self.root, _PLANS)
        stages = os.path.join(self.root, _STAGES)
        for base in ([plans] if os.path.isdir(plans) else []):
            out.extend(os.path.join(base, n) for n in os.listdir(base))
        if os.path.isdir(stages):
            for fp in os.listdir(stages):
                d = os.path.join(stages, fp)
                if os.path.isdir(d):
                    out.extend(os.path.join(d, n) for n in os.listdir(d))
        return [d for d in out if os.path.exists(os.path.join(d, _META))]

    @staticmethod
    def _entry_bytes(d: str) -> int:
        total = 0
        try:
            for name in os.listdir(d):
                try:
                    total += os.path.getsize(os.path.join(d, name))
                except OSError:
                    pass
        except OSError:
            pass
        return total

    def total_bytes(self) -> int:
        """Bytes held by complete entries (the ``max_bytes`` accounting)."""
        return sum(self._entry_bytes(d) for d in self._entries())

    def _evict(self) -> None:
        """Oldest-first eviction keeps the cache dir bounded — by entry
        count (``max_entries``) and, when configured, by total size
        (``max_bytes``)."""
        entries = self._entries()
        if len(entries) <= self.max_entries and self.max_bytes is None:
            return  # common case: one length check, no stat storm

        def mtime(d: str) -> float:
            try:
                return os.path.getmtime(os.path.join(d, _META))
            except OSError:
                return 0.0

        entries.sort(key=mtime)
        drop = max(0, len(entries) - self.max_entries)
        victims = entries[:drop]
        if self.max_bytes is not None:
            sizes = {d: self._entry_bytes(d) for d in entries}
            total = sum(sizes[d] for d in entries[drop:])
            # never evict the newest entry: a single artifact larger than
            # max_bytes would otherwise thrash the store forever
            for d in entries[drop:-1]:
                if total <= self.max_bytes:
                    break
                victims.append(d)
                total -= sizes[d]
        for d in victims:
            shutil.rmtree(d, ignore_errors=True)
            parent = os.path.dirname(d)
            if os.path.basename(os.path.dirname(parent)) == _STAGES:
                try:
                    os.rmdir(parent)  # drop a stage dir left empty
                except OSError:
                    pass
            self.stats.evictions += 1

    # -- operator surface ----------------------------------------------------

    def entries(self) -> list["StoreEntry"]:
        """Typed listing of every complete entry, newest first.

        The operator view behind ``python -m repro_torch.exec.artifact_store
        inspect``: one :class:`StoreEntry` per on-disk artifact with its
        layer, key, size, age, and whether its compat header matches this
        process (stale entries show up as ``compat=False`` instead of
        silently wasting disk until eviction).
        """
        now = time.time()  # analysis: allow[wallclock-timing] — file mtimes
        out: list[StoreEntry] = []
        for d in self._entries():
            meta = self._read_meta(d)
            if meta is None:
                continue
            layer = "plan" if "plan_fingerprint" in meta else "stage"
            if layer == "plan":
                key = os.path.basename(d)
                digest = meta.get("plan_fingerprint", "")
            else:
                key = os.path.basename(os.path.dirname(d))
                digest = meta.get("env_digest", "")
            try:
                mtime = os.path.getmtime(os.path.join(d, _META))
            except OSError:
                mtime = now
            out.append(StoreEntry(
                layer=layer, key=key, digest=digest, path=d,
                size_bytes=self._entry_bytes(d),
                age_s=max(0.0, now - mtime),
                compat=all(meta.get(k) == v for k, v in self.header.items()),
            ))
        out.sort(key=lambda e: e.age_s)
        return out

    def prune(
        self,
        *,
        max_age_s: Optional[float] = None,
        max_bytes: Optional[int] = None,
        keys: Optional[set] = None,
        dry_run: bool = False,
    ) -> list["StoreEntry"]:
        """Drop entries older than ``max_age_s``, whose fingerprint key is
        in ``keys`` (retired-version garbage collection), and/or evict
        oldest-first until the store fits in ``max_bytes``. Returns the
        victims (the would-be victims under ``dry_run``, with nothing
        deleted)."""
        entries = self.entries()  # newest first
        victims: list[StoreEntry] = []
        if max_age_s is not None:
            victims.extend(e for e in entries if e.age_s > max_age_s)
        if keys:
            doomed = {e.path for e in victims}
            victims.extend(
                e for e in entries
                if e.key in keys and e.path not in doomed
            )
        if max_bytes is not None:
            doomed = {e.path for e in victims}
            total = sum(e.size_bytes for e in entries if e.path not in doomed)
            # oldest first, but never the newest entry (mirrors _evict: one
            # oversized artifact must not thrash the store)
            for e in reversed(entries[1:]):
                if total <= max_bytes:
                    break
                if e.path in doomed:
                    continue
                victims.append(e)
                doomed.add(e.path)
                total -= e.size_bytes
        if not dry_run:
            for e in victims:
                shutil.rmtree(e.path, ignore_errors=True)
                parent = os.path.dirname(e.path)
                if os.path.basename(os.path.dirname(parent)) == _STAGES:
                    try:
                        os.rmdir(parent)
                    except OSError:
                        pass
                self.stats.evictions += 1
        return victims


@dataclass(frozen=True)
class StoreEntry:
    """One on-disk artifact as the operator CLI sees it."""

    layer: str       # "plan" | "stage"
    key: str         # query fingerprint (plan) / stage fingerprint (stage)
    digest: str      # plan fingerprint / env digest
    path: str
    size_bytes: int
    age_s: float
    compat: bool     # header matches this process's store/torch/device/kernels


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"  # pragma: no cover - unreachable


def main(argv: Optional[list[str]] = None) -> int:
    """``python -m repro_torch.exec.artifact_store {inspect,prune}`` —
    operator tooling for a store directory shared by serving processes."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.exec.artifact_store",
        description="Inspect or prune a Raven plan-artifact store.",
    )
    ap.add_argument("--root", required=True, help="store directory")
    ap.add_argument("--device", default=None,
                    help="the device entries are checked against (default: the card)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ins = sub.add_parser("inspect", help="list entries (newest first)")
    ins.add_argument("--layer", choices=["plan", "stage"], default=None)
    ins.add_argument("--fingerprint", default=None,
                     help="only entries whose key starts with this prefix")
    ins.add_argument("--min-bytes", type=int, default=0)
    ins.add_argument("--max-age-s", type=float, default=None,
                     help="only entries younger than this")
    ins.add_argument("--json", action="store_true", dest="as_json")

    pr = sub.add_parser("prune", help="delete old/oversized entries")
    pr.add_argument("--max-age-s", type=float, default=None,
                    help="drop entries older than this many seconds")
    pr.add_argument("--max-bytes", type=int, default=None,
                    help="evict oldest-first until the store fits")
    pr.add_argument("--key", action="append", default=None,
                    help="drop entries with this exact fingerprint key "
                         "(repeatable; retired-version GC)")
    pr.add_argument("--dry-run", action="store_true")

    args = ap.parse_args(argv)
    store = ArtifactStore(args.root, device=args.device)

    if args.cmd == "inspect":
        rows = store.entries()
        if args.layer:
            rows = [e for e in rows if e.layer == args.layer]
        if args.fingerprint:
            rows = [e for e in rows if e.key.startswith(args.fingerprint)]
        if args.min_bytes:
            rows = [e for e in rows if e.size_bytes >= args.min_bytes]
        if args.max_age_s is not None:
            rows = [e for e in rows if e.age_s <= args.max_age_s]
        if args.as_json:
            print(json.dumps([e.__dict__ for e in rows], indent=2))
        else:
            for e in rows:
                flag = "" if e.compat else "  [incompatible]"
                print(f"{e.layer:5s} {e.key[:16]:16s} {e.digest[:16]:16s} "
                      f"{_fmt_bytes(e.size_bytes):>10s} "
                      f"{e.age_s:8.0f}s{flag}")
            print(f"-- {len(rows)} entries, "
                  f"{_fmt_bytes(sum(e.size_bytes for e in rows))} total")
        return 0

    if args.max_age_s is None and args.max_bytes is None and not args.key:
        ap.error("prune needs --max-age-s, --max-bytes, and/or --key")
    victims = store.prune(
        max_age_s=args.max_age_s, max_bytes=args.max_bytes,
        keys=set(args.key) if args.key else None,
        dry_run=args.dry_run,
    )
    verb = "would delete" if args.dry_run else "deleted"
    for e in victims:
        print(f"{verb} {e.layer} {e.key[:16]} "
              f"({_fmt_bytes(e.size_bytes)}, {e.age_s:.0f}s old)")
    print(f"-- {verb} {len(victims)} entries, "
          f"{_fmt_bytes(sum(e.size_bytes for e in victims))}")
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    raise SystemExit(main())
