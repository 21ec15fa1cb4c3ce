"""Fair, backpressured multi-queue request scheduling for the serving layer.

This generalizes the single-deadline :class:`RequestPump` (kept below for
embedders that drive one flush callable): instead of one global pending list
flushed wholesale, every served query gets its own queue with its own latency
target and bounds, and one pump thread schedules *groups* across them:

  * **earliest-deadline-first** — each queue's deadline is its oldest
    request's submit time plus that queue's ``max_latency_ms``, so a small
    latency-sensitive query is flushed ahead of a bulk query that arrived
    earlier but can afford to wait;
  * **coalesce-width cap** — one dispatched group takes at most
    ``max_coalesce`` rows off a queue, so a huge backlog is served as a
    sequence of bounded groups (which the pipelined executor overlaps)
    instead of one monolithic flush that monopolizes the server;
  * **bounded queues / backpressure** — ``max_pending`` caps a queue's
    depth; a submit against a full queue blocks until the scheduler frees
    space (or its timeout expires) or fails fast with
    :class:`~repro_torch.errors.ServerOverloadedError`;
  * **bounded dispatch** — at most ``max_inflight`` groups run concurrently,
    so the pump never buries the device/boundary pool under an unbounded
    pile of dispatched work.

The scheduler owns no execution logic: ``dispatch(name, group)`` — supplied
by the server — must return a future resolving when the group's requests
are finished. Failure routing is split by retryability: a group future that
fails with a :class:`~repro_torch.errors.TransientError` is *requeued whole* (the
coalesced group stays one unit) under the queue's
:class:`~repro_torch.exec.faults.RetryPolicy` — exponential backoff rides the
queue's deadline machinery, no thread ever sleeps — until attempts or the
per-query deadline run out, at which point the ``fail`` callback delivers a
typed :class:`~repro_torch.errors.RequestFailedError` to every waiter in the
group (no orphaned waiters, ever). Non-transient failures are expected to
be marked on the affected requests by the dispatch callback itself; the
scheduler still runs ``fail`` defensively and records ``last_error``.
``drain()`` is the synchronous path: it pops and dispatches *everything*
immediately — including requeued groups, whose backoff it ignores (a flush
means "serve now") — which is exactly the old ``server.flush()`` contract,
so the scheduler works with no pump thread at all.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.analysis.runtime import asserts_enabled, runtime_assert
from repro_torch.errors import (
    RequestFailedError,
    ServerOverloadedError,
    TransientError,
)
from repro_torch.exec.faults import RetryPolicy, maybe_inject


@dataclass
class QueryQueue:
    """Per-query pending queue + scheduling knobs."""

    name: str
    reqs: deque = field(default_factory=deque)  # (request, n_rows)
    max_latency_ms: Optional[float] = None  # None -> scheduler default
    max_pending: Optional[int] = None       # None -> unbounded
    max_coalesce: Optional[int] = None      # rows/group; None -> sched default
    last_pop: float = 0.0  # when this queue last got service (fairness key)
    retry: Optional[RetryPolicy] = None     # None -> scheduler default
    # transiently-failed groups awaiting re-dispatch: (group, attempt,
    # not_before) — kept whole so retry never re-splits a coalesced group
    redo: deque = field(default_factory=deque)

    @property
    def depth(self) -> int:
        return len(self.reqs)


def _default_fail(group: list, e: BaseException) -> None:
    """Terminal-failure delivery for bare schedulers (no server): attach
    the error to every not-yet-settled request and wake its waiters. The
    serving layer passes its own ``_fail_group`` instead."""
    for r in group:
        if getattr(r, "done", False):
            continue
        r.error = e
        ev = getattr(r, "_event", None)
        if ev is not None:
            ev.set()


class Scheduler:
    """One pump thread, many queues; EDF flush order; bounded everything."""

    def __init__(
        self,
        dispatch: Callable[[str, list], "Future"],
        *,
        default_latency_ms: float = 5.0,
        default_coalesce: Optional[int] = None,
        max_inflight: int = 4,
        default_retry: Optional[RetryPolicy] = None,
        fail: Optional[Callable[[list, BaseException], None]] = None,
    ):
        self._dispatch = dispatch
        self._fail = fail if fail is not None else _default_fail
        self.default_latency_ms = float(default_latency_ms)
        self.default_coalesce = default_coalesce
        self.max_inflight = max(1, int(max_inflight))
        # retry applies only to TransientError failures, so it is on by
        # default: deterministic failures never enter the retry path
        self.default_retry = (
            default_retry if default_retry is not None else RetryPolicy()
        )
        self._cv = threading.Condition()
        self._queues: dict[str, QueryQueue] = {}
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._inflight = 0
        # pump-group generations: drain() waits only for groups the pump
        # had popped *before* it was called (bounded under sustained load)
        self._pump_started = 0
        self._pump_settled = 0
        # counters (reads are advisory; mutations under _cv)
        self.flushes = 0  # pump-initiated group dispatches
        self.backpressure_waits = 0
        self.overloads = 0
        self.max_queue_depth = 0
        self.retries = 0            # groups requeued after a transient failure
        self.retries_exhausted = 0  # groups failed terminally after retries
        self.last_error: Optional[BaseException] = None

    # -- queue management -----------------------------------------------------

    def configure(
        self,
        name: str,
        *,
        max_latency_ms: Optional[float] = None,
        max_pending: Optional[int] = None,
        max_coalesce: Optional[int] = None,
        retry: Optional[RetryPolicy] = None,
    ) -> QueryQueue:
        """Create (or retune) the queue for ``name``; None leaves a knob."""
        with self._cv:
            q = self._queues.get(name)
            if q is None:
                q = self._queues[name] = QueryQueue(name=name)
            if max_latency_ms is not None:
                q.max_latency_ms = float(max_latency_ms)
            if max_pending is not None:
                q.max_pending = int(max_pending)
            if max_coalesce is not None:
                q.max_coalesce = int(max_coalesce)
            if retry is not None:
                q.retry = retry
            return q

    def depths(self) -> dict[str, int]:
        with self._cv:
            return {n: q.depth for n, q in self._queues.items() if q.depth}

    def hold(self):
        """Context manager freezing group selection for an atomic routing
        change (version cutover). Both the pump loop and ``drain()`` pop
        groups under ``_cv`` but *dispatch outside it*, so while held no new
        group can be popped — yet already-dispatched groups keep executing
        and enqueues keep landing. The caller mutates routing inside the
        ``with`` block; every group popped afterwards sees the new route.
        """
        return self._cv

    def snapshot(self) -> dict[str, Any]:
        with self._cv:
            return {
                "pump_flushes": self.flushes,
                "groups_inflight": self._inflight,
                "backpressure_waits": self.backpressure_waits,
                "overloads": self.overloads,
                "max_queue_depth": self.max_queue_depth,
                "retries": self.retries,
                "retries_exhausted": self.retries_exhausted,
                "redo_depth": sum(
                    len(q.redo) for q in self._queues.values()
                ),
            }

    # -- producer side --------------------------------------------------------

    def enqueue(
        self,
        name: str,
        req,
        n_rows: int,
        *,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> None:
        """Queue one request; applies the queue's ``max_pending`` bound."""
        with self._cv:
            q = self._queues.get(name)
            if q is None:
                q = self._queues[name] = QueryQueue(name=name)
            if q.max_pending is not None and q.depth >= q.max_pending:
                if not block:
                    self.overloads += 1
                    raise ServerOverloadedError(self._overload_msg(q))
                if timeout is None and not self.running:
                    # nothing will ever free space: the synchronous protocol
                    # drains via flush(), which this blocked caller can
                    # never reach — fail fast instead of hanging forever
                    self.overloads += 1
                    raise ServerOverloadedError(
                        self._overload_msg(q) + " (no pump thread is "
                        "running: call flush(), or submit with a timeout)"
                    )
                self.backpressure_waits += 1
                end = None if timeout is None else time.monotonic() + timeout
                while q.depth >= q.max_pending:
                    if timeout is None and not self.running:
                        # the pump died (stop() racing this wait): nothing
                        # will free space anymore — reject, don't strand
                        self.overloads += 1
                        raise ServerOverloadedError(self._overload_msg(q))
                    left = None if end is None else end - time.monotonic()
                    if left is not None and left <= 0:
                        self.overloads += 1
                        raise ServerOverloadedError(self._overload_msg(q))
                    self._cv.wait(left if left is not None else 1.0)
            q.reqs.append((req, int(n_rows)))
            self.max_queue_depth = max(self.max_queue_depth, q.depth)
            self._cv.notify_all()

    def _overload_msg(self, q: QueryQueue) -> str:
        return (
            f"query '{q.name}' is overloaded: {q.depth} pending requests "
            f"at max_pending={q.max_pending} — shed load, raise the bound, "
            f"or wait for the scheduler to catch up"
        )

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Scheduler":
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stopped = False
            self._thread = threading.Thread(
                target=self._loop, name="raven-scheduler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the pump thread, then drain anything still pending."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)
        self.drain()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- scheduling -----------------------------------------------------------

    def _deadline(self, q: QueryQueue) -> float:
        """When ``q`` next wants service: its oldest fresh request's latency
        deadline, or a requeued group's backoff expiry — whichever is
        sooner. Backoff is therefore just a deadline in the future: the
        pump's existing timed wait implements it with no sleeping thread."""
        ds = []
        if q.reqs:
            target = (
                q.max_latency_ms if q.max_latency_ms is not None
                else self.default_latency_ms
            )
            ds.append(q.reqs[0][0].t_submit + target / 1e3)
        if q.redo:
            ds.append(min(nb for _g, _a, nb in q.redo))
        return min(ds)

    def _earliest(self, now: Optional[float] = None) -> Optional[QueryQueue]:
        """The nonempty queue to serve next: earliest deadline first, with a
        fairness guard — among queues *already past* their deadline, the
        least-recently-served wins. Pure EDF would let a deep bulk backlog
        (every group maximally overdue) monopolize the pump: a small query's
        later-submitted requests have later deadlines, so they would starve
        exactly when the server is busiest. Rotating overdue queues bounds a
        small query's wait to ~one group of every other queue."""
        if now is None:
            now = time.perf_counter()
        best: Optional[QueryQueue] = None
        best_key: tuple = ()
        for q in self._queues.values():
            if not q.reqs and not q.redo:
                continue
            d = self._deadline(q)
            # not yet due: sort by deadline after every overdue queue;
            # overdue: sort by last service time (then deadline)
            key = (
                (1, d, 0.0) if d > now else (0, q.last_pop, d)
            )
            if best is None or key < best_key:
                best, best_key = q, key
        return best

    def _pop_group(
        self, q: QueryQueue, due_only: bool = True
    ) -> tuple[list, int]:
        """Take the next unit of work off ``q``: a requeued group whose
        backoff has expired (served whole — retry never re-splits a
        coalesced group) ahead of fresh requests, else the head of the
        fresh queue up to its coalesce-width cap. Returns
        ``(group, attempt)``; fresh groups are attempt 0. ``due_only=False``
        (drain) ignores backoff expiry — a flush means "serve now"."""
        now = time.perf_counter()
        for i, (group, attempt, nb) in enumerate(q.redo):
            if due_only and nb > now:
                continue
            del q.redo[i]
            q.last_pop = now
            self._cv.notify_all()
            return group, attempt
        cap = (
            q.max_coalesce if q.max_coalesce is not None
            else self.default_coalesce
        )
        group = []
        rows = 0
        while q.reqs:
            req, n = q.reqs[0]
            if group and cap is not None and rows + n > cap:
                break
            q.reqs.popleft()
            group.append(req)
            rows += n
        q.last_pop = now
        self._cv.notify_all()  # wake backpressured submitters
        if asserts_enabled():
            runtime_assert(len(group) >= 1, "popped an empty group")
            rids = [id(r) for r in group]
            runtime_assert(
                len(rids) == len(set(rids)),
                f"popped group for '{q.name}' contains duplicate requests",
            )
        return group, 0

    def _loop(self) -> None:
        while True:
            with self._cv:
                q: Optional[QueryQueue] = None
                while not self._stopped:
                    q = self._earliest()
                    if q is None:
                        self._cv.wait()
                        continue
                    wait_s = self._deadline(q) - time.perf_counter()
                    if wait_s > 0:
                        # coalescing window still open: later submits ride
                        # along; an earlier deadline re-notifies the cv
                        self._cv.wait(wait_s)
                        continue
                    if self._inflight >= self.max_inflight:
                        self._cv.wait(0.05)
                        continue
                    break
                if self._stopped:
                    return
                group, attempt = self._pop_group(q)
                self._inflight += 1
                self._pump_started += 1
                self.flushes += 1
                name = q.name
            fut = self._dispatch_safe(name, group)
            fut.add_done_callback(
                lambda f, n=name, g=group, a=attempt: self._group_done(
                    f, n, g, a
                )
            )

    def _group_done(
        self, fut: "Future", name: str, group: list, attempt: int
    ) -> None:
        e = fut.exception()
        if e is not None:
            self._settle_failure(name, group, attempt, e)
        with self._cv:
            self._inflight -= 1
            self._pump_settled += 1
            if e is not None:
                self.last_error = e
            self._cv.notify_all()

    def _settle_failure(
        self, name: str, group: list, attempt: int, e: BaseException
    ) -> Optional[BaseException]:
        """Route one dispatched group's failure.

        Transient failures with retry budget left are requeued whole
        (returns None); everything else is terminal — the ``fail`` callback
        marks every request in the group so no waiter is ever orphaned, and
        the terminal error is returned for the synchronous path to raise.
        """
        attempts = attempt + 1
        if isinstance(e, TransientError):
            with self._cv:
                q = self._queues.get(name)
                policy = (
                    q.retry if q is not None and q.retry is not None
                    else self.default_retry
                )
                within_deadline = True
                if policy is not None and policy.deadline_ms is not None:
                    oldest = min(
                        (getattr(r, "t_submit", None) for r in group),
                        default=None,
                        key=lambda t: float("inf") if t is None else t,
                    )
                    if oldest is not None:
                        elapsed_ms = (time.perf_counter() - oldest) * 1e3
                        within_deadline = elapsed_ms < policy.deadline_ms
                if (
                    policy is not None
                    and q is not None
                    and attempts < policy.max_attempts
                    and within_deadline
                ):
                    nb = time.perf_counter() + policy.delay_s(attempts, name)
                    q.redo.append((group, attempts, nb))
                    self.retries += 1
                    self._cv.notify_all()
                    return None
                self.retries_exhausted += 1
            terminal: BaseException = RequestFailedError(
                f"group for '{name}' failed after {attempts} attempt(s): {e}",
                attempts=attempts,
            )
            terminal.__cause__ = e
        else:
            # deterministic failure: the dispatch callback already marked
            # the requests; fail() below is an idempotent safety net
            terminal = e
        self._fail(group, terminal)
        return terminal

    def _dispatch_safe(self, name: str, group: list) -> "Future":
        try:
            # "worker" fault site: the scheduler worker dies mid-dispatch —
            # the popped group must flow into the retry path, never be lost
            maybe_inject("worker", token=name)
            return self._dispatch(name, group)
        except BaseException as e:  # noqa: BLE001 — contain; requests carry it
            f: Future = Future()
            f.set_exception(e)
            return f

    # -- the synchronous path -------------------------------------------------

    def drain(self) -> list:
        """Snapshot and dispatch every *currently pending* request (EDF
        order), wait for completion, and return the drained requests.
        Re-raises the first *terminal* group failure after every group has
        settled — the old synchronous ``flush()`` contract. Transient
        failures are retried inline (backoff ignored — the caller is
        already blocked waiting) until they succeed or exhaust their
        policy, so a flush never returns with a request still pending.

        Bounded under sustained load: requests submitted after the snapshot
        ride the next flush, and the final wait covers only pump groups
        popped before this call — so "submit, flush, read the result" stays
        correct even when the pump raced this call to the queue, without
        flush() chasing global quiescence forever. Retry rounds are bounded
        by ``RetryPolicy.max_attempts``."""
        drained: list = []
        first: Optional[BaseException] = None
        with self._cv:
            pump_target = self._pump_started
        while True:
            todo: list[tuple[str, list, int]] = []
            with self._cv:
                while True:
                    q = self._earliest()
                    if q is None:
                        break
                    group, attempt = self._pop_group(q, due_only=False)
                    todo.append((q.name, group, attempt))
            if not todo:
                with self._cv:
                    if self._pump_settled < pump_target:
                        # pump groups popped before this call may still
                        # settle into a retry requeue we must then serve
                        self._cv.wait(1.0)
                        continue
                    if any(q.redo for q in self._queues.values()):
                        continue
                    if first is not None:
                        self.last_error = first
                break
            if asserts_enabled():
                ids = [id(r) for _name, g, _a in todo for r in g]
                runtime_assert(
                    len(ids) == len(set(ids)),
                    "drain snapshot contains duplicated requests",
                )
            dispatched = [
                (name, group, attempt, self._dispatch_safe(name, group))
                for name, group, attempt in todo
            ]
            drained.extend(
                r for _n, group, attempt, _f in dispatched
                if attempt == 0 for r in group
            )
            for name, group, attempt, fut in dispatched:
                e = fut.exception()  # blocks until the group settles
                if e is None:
                    continue
                terminal = self._settle_failure(name, group, attempt, e)
                if terminal is not None and first is None:
                    first = terminal
        if first is not None:
            raise first
        return drained


# ---------------------------------------------------------------------------
# The original single-deadline pump
# ---------------------------------------------------------------------------


class RequestPump:
    """Background thread driving one ``flush`` callable against a latency
    target — the minimal pump for embedders that don't need per-query queues.

    The :class:`Scheduler` above subsumes this for the serving layer (it is
    what :class:`~repro_torch.serve.query_server.PredictionQueryServer` runs); the
    pump owns no queue state of its own: ``notify(t_submit)`` arms a deadline
    tracking the *oldest* pending request, the loop sleeps until it, and the
    flush callable does the actual draining. Explicit ``flush()`` calls
    remain safe at any time — flushing is idempotent on an empty queue.
    """

    def __init__(self, flush: Callable[[], list], max_latency_ms: float = 5.0):
        self._flush = flush
        self.max_latency_ms = float(max_latency_ms)
        self._cv = threading.Condition()
        self._deadline: float | None = None
        self._stopped = False
        self._thread: threading.Thread | None = None
        self.flushes = 0  # flushes this pump initiated
        self.last_error: BaseException | None = None  # most recent flush failure

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "RequestPump":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="raven-request-pump", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the pump after draining anything already pending."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._flush()  # drain stragglers deterministically

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- producer side -------------------------------------------------------

    def notify(self, t_submit: float | None = None) -> None:
        """Arm the flush deadline for a newly submitted request.

        The deadline tracks the oldest pending request: later submits never
        push it back, they just ride along in the same flush.
        """
        t = time.perf_counter() if t_submit is None else t_submit
        with self._cv:
            deadline = t + self.max_latency_ms / 1e3
            if self._deadline is None or deadline < self._deadline:
                self._deadline = deadline
            self._cv.notify_all()

    # -- the loop ------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and self._deadline is None:
                    self._cv.wait()
                if self._stopped:
                    return
                wait_s = self._deadline - time.perf_counter()
                if wait_s > 0:
                    self._cv.wait(wait_s)
                    continue  # re-check: stop/new earlier deadline may race
                self._deadline = None
            # count before running: waiters wake *inside* flush (their
            # request's event sets mid-drain), so counting after would let a
            # woken waiter observe flushes == 0 for the flush that served it
            self.flushes += 1
            try:
                self._flush()
            except BaseException as e:  # noqa: BLE001
                # the server already attached the error to the affected
                # requests (their wait() re-raises); the pump must survive a
                # bad batch or every later submit would hang forever
                self.last_error = e
