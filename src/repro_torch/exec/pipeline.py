"""Pipelined StageGraph execution: overlap host and device work across groups.

The serial runner (:func:`repro_torch.exec.stages.run_graph`) blocks at
every stage, so a plan with an MLUdf host boundary leaves the card idle
while numpy churns through the interpreted pipeline — and leaves the host
idle while the card runs the pure stages. :class:`PipelineExecutor` runs the
*same* stages (the same captured graphs, the same env structure, so warm
buckets stay warm) as a pipeline over request groups:

  * **pure (device) stages are enqueued** on the calling thread: a graph
    replay, like JAX's async dispatch, returns as soon as the work is on the
    stream, so the scheduler thread spends microseconds per stage and moves
    on to the next group;
  * **host boundaries run on a dedicated boundary pool**: the only point
    that must wait for the card (the copy of the upstream state to the
    host) happens on a worker thread, which waits on a ``torch.cuda.Event``
    recorded right after the upstream stage was enqueued, never on the
    whole device; so group B's entry stages run on the card while group A
    sits in its MLUdf boundary — and two UDF-heavy groups can occupy two
    workers at once (numpy releases the GIL in the kernels that matter);
  * a graph whose remaining stages are all pure completes inline on the
    dispatching thread — its future resolves immediately and the caller's
    result conversion provides the synchronization. This keeps small
    latency-sensitive pure queries out of the boundary pool's queue, so a
    large host-bound group can never sit in front of them.

Every thread enqueues on its current stream, which is the card's default
stream unless a caller set another: one stream, so the card runs the groups'
work in the order it was enqueued, a tensor made by one thread and read by
another needs no ``record_stream``, and a graph's buffers are never used by
two replays at once (each replay also holds its graph's lock while it
enqueues).

The executor also owns the pipelining gauges (groups in flight, overlap
wall time, host-pool busy time) surfaced through ``db.cache_stats()``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Optional

import torch

from repro_torch.exec.stages import (
    RunResult,
    StageGraph,
    State,
    call_pure,
    host_step,
    strip_consumed,
)
from repro_torch.relational.table import Table


class PipelineExecutor:
    """Boundary thread pool + in-flight accounting for pipelined groups."""

    def __init__(self, workers: int = 2):
        self.workers = max(1, int(workers))
        self._pool: Optional[ThreadPoolExecutor] = None
        self._closed = False
        self._lock = threading.Lock()
        # gauges (all mutated under _lock)
        self.groups_in_flight = 0
        self.max_groups_in_flight = 0
        self.groups_started = 0
        self.overlapped_groups = 0  # groups that began while another ran
        self.overlap_s = 0.0        # wall time with >= 2 groups in flight
        self.host_busy_s = 0.0      # wall time spent inside host boundaries
        self._t_mark: float = 0.0

    @property
    def pool(self) -> ThreadPoolExecutor:
        """The boundary pool, created on first use.

        After :meth:`shutdown` the (shut-down) pool is returned as-is, so a
        straggling dispatch fails with the executor's RuntimeError instead
        of silently resurrecting a fresh pool nothing will ever shut down.
        """
        with self._lock:
            if self._pool is None and not self._closed:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="raven-boundary",
                )
            if self._pool is None:
                raise RuntimeError("PipelineExecutor is shut down")
            return self._pool

    def shutdown(self) -> None:
        with self._lock:
            self._closed = True
            pool = self._pool
        if pool is not None:
            pool.shutdown(wait=False)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "groups_in_flight": self.groups_in_flight,
                "max_groups_in_flight": self.max_groups_in_flight,
                "groups_started": self.groups_started,
                "overlapped_groups": self.overlapped_groups,
                "overlap_s": self.overlap_s,
                "host_busy_s": self.host_busy_s,
            }

    # -- in-flight / overlap accounting --------------------------------------

    def _accrue(self, now: float) -> None:
        # caller holds _lock; overlap accumulates only while >= 2 groups
        # were simultaneously in flight since the last transition
        if self.groups_in_flight >= 2:
            self.overlap_s += now - self._t_mark
        self._t_mark = now

    def _enter_group(self) -> None:
        with self._lock:
            now = time.perf_counter()
            self._accrue(now)
            if self.groups_in_flight >= 1:
                self.overlapped_groups += 1
            self.groups_in_flight += 1
            self.groups_started += 1
            self.max_groups_in_flight = max(
                self.max_groups_in_flight, self.groups_in_flight
            )

    def _exit_group(self) -> None:
        with self._lock:
            self._accrue(time.perf_counter())
            self.groups_in_flight -= 1

    # -- the pipelined walk ---------------------------------------------------

    def run_graph_async(
        self,
        graph: StageGraph,
        env: dict[str, Any],
        *,
        bucketer: Optional[Callable[[int], int]] = None,
        on_mid_bucket: Optional[Callable[[int, int], None]] = None,
        donate: frozenset = frozenset(),
    ) -> "Future[RunResult]":
        """Execute ``graph`` with host/device overlap; returns a future.

        Semantics are identical to :func:`repro_torch.exec.stages.run_graph`
        — the same stage callables run over the same env structure — only
        the synchronization points move: pure stages are enqueued without
        waiting, and each host boundary (plus everything after it) runs on
        the boundary pool, after the event recorded behind its upstream
        stage.
        """
        fut: Future = Future()
        self._enter_group()
        try:
            self._advance(graph, 0, None, env, bucketer, on_mid_bucket,
                          donate, [], fut)
        except BaseException as e:  # noqa: BLE001 — delivered via the future
            self._finish(fut, error=e)
        return fut

    def _advance(
        self,
        graph: StageGraph,
        start: int,
        state: Optional[State],
        env: dict[str, Any],
        bucketer,
        on_mid_bucket,
        donate: frozenset,
        timings: list[float],
        fut: Future,
    ) -> None:
        """Run stages from ``start`` on the current thread until the next
        host boundary (handed to the pool) or the end of the graph."""
        ready = None  # an event behind the last stage enqueued here
        for i in range(start, len(graph.stages)):
            stage = graph.stages[i]
            t0 = time.perf_counter()
            if stage.kind == "pure":
                state = call_pure(stage, env, donate)
                if state[1].is_cuda:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(state[1].device))
                dt = time.perf_counter() - t0
                if stage.index == 0:
                    env = strip_consumed(env, donate)
                with self._lock:
                    # async dispatch has no meaningful per-stage wall time
                    # (the device work overlaps other groups), so only the
                    # dispatch-side accounting moves — calls/total_s stay
                    # the serial runner's blocking-wall measure
                    stage.async_calls += 1
                    stage.dispatch_s += dt
                timings.append(dt)
                continue

            # host boundary: everything from here on runs on the pool, and
            # the dispatching thread returns to its scheduler loop
            def boundary(
                _stage=stage, _state=state, _env=env, _i=i, _ready=ready,
            ) -> None:
                t1 = time.perf_counter()
                try:
                    new_state, new_env = host_step(
                        _stage, _state, _env,
                        bucketer=bucketer, on_mid_bucket=on_mid_bucket,
                        ready=_ready,
                    )
                except BaseException as e:  # noqa: BLE001
                    self._finish(fut, error=e)
                    return
                dt1 = time.perf_counter() - t1
                with self._lock:
                    _stage.calls += 1
                    _stage.total_s += dt1
                    _stage.async_calls += 1
                    _stage.dispatch_s += dt1
                    self.host_busy_s += dt1
                timings.append(dt1)
                try:
                    self._advance(graph, _i + 1, new_state, new_env,
                                  bucketer, on_mid_bucket, donate,
                                  timings, fut)
                except BaseException as e:  # noqa: BLE001
                    self._finish(fut, error=e)

            self.pool.submit(boundary)
            return

        cols, valid, seg = state
        self._finish(fut, result=RunResult(
            table=Table(columns=cols, valid=valid), seg=seg, timings=timings,
        ))

    def _finish(self, fut: Future, *, result=None, error=None) -> None:
        self._exit_group()
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
