"""Capture: the port's counterpart of ``jax.jit``.

On the card a pure stage runs as a CUDA graph. The first call of each input
structure (the key: the env's tree structure, every leaf's shape and dtype,
the device) runs the stage once eagerly on a side stream, which builds every
lazy cache the stage keeps (an expression's constants on the card, a join's
sorted payload, a kernel's shared-memory limit), then captures it into a
graph and replays that; the call's result comes from the replay. Later calls
of the key only replay. A replay enqueues the whole stage at once, so the
host no longer pays for launching each kernel and small op in it.

A graph reads its inputs where it captured them. Its key's single-use
inputs (the env's ``VOLATILE_KEYS``, and the tables a run donates: the
serving layer's padded fact spine, a one-shot call's batch) get buffers of
their own at capture, and each replay copies the call's values into them:
the port's counterpart of donating buffers to XLA is that these buffers are
reused by every replay. The tables a session uploaded once are read where
they lie and never copied; a call whose resident tables lie elsewhere (a
database uploaded again for one call) gets a graph of its own. Outputs are
cloned out of the graph's memory after the replay, so a caller's result
never aliases the next replay's.

Graphs are held in one least-recently-used cache of ``GRAPH_CAPACITY``
entries, the plan cache's capacity; a graph also keeps alive every tensor
it reads (the stage function's constants, the resident tables, the join's
cached payloads), so no address it baked in is ever reused under it.
:func:`disabled` runs every stage eagerly (``jax.disable_jit``'s
counterpart: the A/B switch), and the CPU never captures.
"""
from __future__ import annotations

import itertools
import threading
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Callable, Optional

import torch

from repro_torch.exec.stages import DIMSORT_CACHE, DIMSORT_KEY, VOLATILE_KEYS, State
from repro_torch.kernels import _build

GRAPH_CAPACITY = 64  # the plan cache's capacity (PLAN_CACHE_CAPACITY)

_lock = threading.Lock()  # guards the cache and the switch
_disabled = 0
# one capture at a time in the process: the caching allocator gives each
# capture a private pool, and two captures racing for one key would both run
CAPTURE_LOCK = threading.Lock()
_graphs: "OrderedDict[tuple, StageCapture]" = OrderedDict()
_serials = itertools.count()
_evicted = 0  # graphs dropped to keep the cache at GRAPH_CAPACITY
_evicted_of: dict[int, int] = {}  # owner serial -> its graphs dropped
_captured = 0  # graphs captured in this process


@contextmanager
def disabled():
    """Run every pure stage and decode tick eagerly while inside, in every
    thread (the counterpart of ``jax.disable_jit``): captured and eager runs
    compare under one process. Graphs already captured are kept."""
    global _disabled
    with _lock:
        _disabled += 1
    try:
        yield
    finally:
        with _lock:
            _disabled -= 1


def enabled() -> bool:
    """Whether work on the card is captured (no :func:`disabled` open)."""
    return _disabled == 0


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def _sig(x) -> Any:
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    return ("S", type(x).__name__, x)


def env_key(env: dict[str, Any]) -> tuple:
    """The specialization key of an env: its tree structure and every
    leaf's shape, dtype and device (a dimsort entry's payload cache left
    out: it is a cache, not an input)."""
    out = []
    for k, v in sorted(env.items()):
        if k == DIMSORT_KEY:
            v = {t: {kk: vv for kk, vv in e.items() if kk != DIMSORT_CACHE}
                 for t, e in v.items()}
        out.append((k, _sig(v)))
    return tuple(out)


def _read_part(env: dict, reads: dict, volatile: frozenset) -> dict:
    """The part of ``env`` a stage reads: the tables of ``reads`` (their
    columns), the dimsort entries of its joins (the entry dicts themselves,
    so a cache the warm-up builds in one stays in the database's entry) and
    the per-call keys present."""
    out: dict[str, Any] = {}
    for k, v in env.items():
        if k == DIMSORT_KEY:
            out[k] = {t: e for t, e in v.items() if t in reads}
        elif k in reads:
            out[k] = {c: v[c] for c in reads[k]}
        elif k in VOLATILE_KEYS:
            out[k] = v
    return out


def _leaves(tree, path: tuple = ()):
    """(path, tensor) of every tensor under ``tree``, a dimsort entry's
    payload cache left out."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if not (len(path) == 2 and path[0] == DIMSORT_KEY and k == DIMSORT_CACHE):
                yield from _leaves(v, path + (k,))


def resident_key(env: dict, reads: dict, volatile: frozenset) -> tuple:
    """Where the resident tensors a stage reads lie: a graph is valid only
    for these addresses."""
    part = _read_part(env, reads, volatile)
    return tuple((p, t.data_ptr(), tuple(t.stride()))
                 for p, t in _leaves(part) if p[0] not in volatile)


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# Recording a graph
# ---------------------------------------------------------------------------


def record(fn: Callable[[], Any], device) -> tuple["torch.cuda.CUDAGraph", Any, dict, int]:
    """Run ``fn`` once eagerly on a side stream (the warm-up), then capture
    it into a CUDA graph on that stream. Returns the graph, the tensors the
    captured call returned (its static outputs, overwritten by each
    replay), the kernel launches recorded into it, and the bytes the
    capture reserved for the graph's private memory pool. Raises where the
    capture fails; nothing falls back to eager work."""
    device = torch.device(device)
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.device(device), torch.cuda.stream(side):
        fn()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    tally: dict[str, int] = {}
    with torch.cuda.device(device), torch.cuda.stream(side), _build.recording(tally):
        # thread-local: another thread's work on the card (a host
        # boundary's copies, another group's replay) does not break it
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the capture was invalidated by the error raised here
            raise
        graph.capture_end()
    cur.wait_stream(side)
    return graph, out, tally, torch.cuda.memory_reserved(device) - reserved


def _clone_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree


def clone_state(state: State) -> State:
    """A stage's outputs cloned out of a graph's memory."""
    cols, valid, seg = state
    return ({k: v.clone() for k, v in cols.items()}, valid.clone(),
            None if seg is None else seg.clone())


class StageCapture:
    """One pure stage captured for one key: the graph, the env it reads
    (per-call inputs in buffers of its own, resident tables by reference),
    its static outputs and the kernel launches one replay makes."""

    def __init__(self, stage, env: dict, volatile: frozenset, device):
        part = _read_part(env, stage.reads, volatile)
        static = {k: (_clone_tree(v) if k in volatile else v) for k, v in part.items()}
        # the copy targets of every replay: the per-call leaves' buffers
        self.inputs = [(p, t) for p, t in _leaves(static) if p[0] in volatile]
        fn = stage.fn
        self.graph, self.out, self.launches, pool = record(lambda: fn(static), device)
        self.static = static
        # what the graph reads besides its env: the stage's constants (in
        # its closures) and its tensor programs' buffers as they are now (a
        # program moved to another device and back gets new buffers; the
        # graph keeps reading these)
        self.fn = fn
        self.programs = [t for op in stage.ops
                         if isinstance(getattr(op, "fn", None), torch.nn.Module)
                         for t in (*op.fn.buffers(), *op.fn.parameters())]
        self.nbytes = pool + sum(t.numel() * t.element_size() for _, t in self.inputs)
        self._lock = threading.Lock()

    def replay(self, env: dict, fresh: bool = False) -> tuple[State, int]:
        """Copy the call's per-call inputs into the graph's buffers (each
        whose address differs; none on the call that captured, ``fresh``),
        replay, and clone the outputs. Returns the outputs and the number
        of copies. Everything is enqueued on the current stream, under this
        graph's lock: two threads never interleave one graph's buffers."""
        copies = 0
        with self._lock:
            if not fresh:
                for path, buf in self.inputs:
                    src = _at(env, path)
                    if src.data_ptr() != buf.data_ptr():
                        buf.copy_(src)
                        copies += 1
            self.graph.replay()
            out = clone_state(self.out)
        for name, n in self.launches.items():
            _build.launched(name, n)
        return out, copies


# ---------------------------------------------------------------------------
# The cache of graphs
# ---------------------------------------------------------------------------


def new_owner(owner) -> int:
    """A serial for ``owner`` (a stage runner) under which its graphs are
    cached; they are dropped when the owner is collected."""
    serial = next(_serials)
    weakref.finalize(owner, release, serial)
    return serial


def release(serial: int) -> None:
    """Drop the graphs cached under owner ``serial`` (not counted as
    evictions)."""
    with _lock:
        for k in [k for k in _graphs if k[0] == serial]:
            del _graphs[k]
        _evicted_of.pop(serial, None)


def lookup(key: tuple) -> Optional[StageCapture]:
    with _lock:
        graph = _graphs.get(key)
        if graph is not None:
            _graphs.move_to_end(key)
        return graph


def insert(key: tuple, graph: StageCapture) -> None:
    global _evicted, _captured
    with _lock:
        _graphs[key] = graph
        _captured += 1
        while len(_graphs) > GRAPH_CAPACITY:
            (owner, *_), _ = _graphs.popitem(last=False)
            _evicted += 1
            _evicted_of[owner] = _evicted_of.get(owner, 0) + 1


def evictions() -> int:
    """Graphs the cache has dropped, least recently used first, to stay at
    ``GRAPH_CAPACITY`` (a graph dropped with its stage is not counted)."""
    return _evicted


def captures() -> int:
    """Graphs captured in this process so far (evicted ones included)."""
    return _captured


def owned(serial: int) -> tuple[int, int]:
    """The graphs held under owner ``serial`` and those the cache dropped
    to stay at ``GRAPH_CAPACITY``: a warmed bucket whose graph was dropped
    is captured again on its next call."""
    with _lock:
        return sum(1 for k in _graphs if k[0] == serial), _evicted_of.get(serial, 0)


def held() -> tuple[int, int]:
    """The graphs held and the bytes of card memory they hold (their pools
    as reserved at capture, and their input buffers)."""
    with _lock:
        return len(_graphs), sum(g.nbytes for g in _graphs.values())


def clear() -> None:
    with _lock:
        _graphs.clear()
