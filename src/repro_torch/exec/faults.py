"""Deterministic fault injection + the fault-tolerance policy types.

Every recovery path in the serving stack — group retry, circuit-breaker
degradation, automated rollback, crash recovery — needs a *reproducible*
trigger, or its tests devolve into sleeps and luck. This module provides
one: a seeded :class:`FaultPlan` installable process-wide (via
``connect(options=ConnectOptions(faults=...))`` or the ``RAVEN_FAULTS``
env var) whose specs fire at named sites instrumented throughout the
stack:

==============  ============================================================
site            instrumented where
==============  ============================================================
``dispatch``    ``PredictionQueryServer._dispatch_group`` — the whole group
                dispatch raises before any stage runs
``stage``       ``_StageRunner`` — a pure (jitted) stage raises at call time
``compile``     ``_StageRunner`` — raises only when the call would trace a
                new specialization (a "compile" failure, not a run failure)
``udf``         ``host_step`` — the MLUdf host boundary raises
``store-read``  ``ArtifactStore.load_stage``/``load_plan`` — the entry is
                treated as corrupt (quarantined + counted), caller falls
                back to live compilation
``latency``     ``_StageRunner`` — injects a stall of ``delay_ms`` instead
                of an error (slow-stage spike)
``worker``      ``Scheduler`` dispatch path — the scheduler worker "dies"
                mid-dispatch; the popped group must be requeued, not lost
==============  ============================================================

Firing is a pure function of ``(seed, site, per-spec call counter)`` — no
RNG state, no wall clock — so a plan injects the *same* faults at the same
call indices on every run regardless of thread interleaving within a site.

The policy types live here too (rather than in the scheduler / registry
modules that consume them) so ``repro_torch.options`` can reference them without
import cycles: :class:`RetryPolicy` drives group retry with exponential
backoff + deterministic jitter, and :class:`RollbackPolicy` sets the
thresholds the registry's ``RollbackGuard`` watches.
"""
from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.errors import FaultInjectedError, TransientFaultError

SITES = (
    "dispatch", "stage", "compile", "udf", "store-read", "latency", "worker",
)


def _unit_hash(*parts) -> float:
    """Deterministic pseudo-uniform value in [0, 1) from the parts."""
    h = hashlib.sha1(":".join(str(p) for p in parts).encode()).hexdigest()
    return int(h[:12], 16) / float(16 ** 12)


@dataclass(frozen=True)
class FaultSpec:
    """One injection rule: fire at ``site`` on matching calls.

    ``rate`` is the per-call firing probability (decided deterministically
    from the plan seed and the call index); ``times`` caps total firings
    (None = unlimited); ``after`` skips the first N matching calls;
    ``match`` restricts firing to calls whose token (stage fingerprint,
    queue name, ...) contains the substring; ``transient`` picks the raised
    type (:class:`~repro_torch.errors.TransientFaultError` — retryable — vs the
    terminal :class:`~repro_torch.errors.FaultInjectedError`); ``delay_ms`` turns
    the firing into a stall instead of an error (``site="latency"``)."""

    site: str
    rate: float = 1.0
    times: Optional[int] = None
    after: int = 0
    match: str = ""
    transient: bool = True
    delay_ms: float = 0.0


class FaultPlan:
    """A seeded set of :class:`FaultSpec` rules with per-spec counters.

    Thread-safe; ``injected()`` reports how many faults actually fired per
    site, which the serving layer surfaces through ``stats_snapshot()``.
    """

    def __init__(self, specs=(), seed: int = 0):
        # normalize the convenient spellings: a {site: {key: val}} dict, a
        # list of FaultSpec / site-name strings, or a ready spec tuple
        norm: list[FaultSpec] = []
        items = specs.items() if isinstance(specs, dict) else (
            (s, None) for s in specs
        )
        for s, kw in items:
            if isinstance(s, FaultSpec):
                norm.append(s)
            elif isinstance(s, str):
                norm.append(FaultSpec(site=s, **(kw or {})))
            else:
                raise TypeError(
                    f"FaultPlan spec must be FaultSpec or site name, got "
                    f"{type(s).__name__}"
                )
        for s in norm:
            if s.site not in SITES:
                raise ValueError(
                    f"FaultPlan: unknown site {s.site!r} (sites: {SITES})"
                )
        self.specs: tuple[FaultSpec, ...] = tuple(norm)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._calls = [0] * len(self.specs)
        self._fired = [0] * len(self.specs)

    def __fingerprint_token__(self):
        return ("FaultPlan", self.seed) + tuple(
            (s.site, s.rate, s.times, s.after, s.match, s.transient,
             s.delay_ms)
            for s in self.specs
        )

    def check(self, site: str, token: str = "") -> Optional[FaultSpec]:
        """Count a call at ``site`` and return the spec to apply, if any."""
        with self._lock:
            for i, s in enumerate(self.specs):
                if s.site != site:
                    continue
                if s.match and s.match not in token:
                    continue
                k = self._calls[i]
                self._calls[i] = k + 1
                if k < s.after:
                    continue
                if s.times is not None and self._fired[i] >= s.times:
                    continue
                if s.rate < 1.0 and _unit_hash(self.seed, site, i, k) >= s.rate:
                    continue
                self._fired[i] += 1
                return s
        return None

    def injected(self) -> dict[str, int]:
        """Faults actually fired, keyed by site."""
        with self._lock:
            out: dict[str, int] = {}
            for s, n in zip(self.specs, self._fired):
                if n:
                    out[s.site] = out.get(s.site, 0) + n
            return out

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse the ``RAVEN_FAULTS`` env format.

        ``"seed=7;stage:times=2;latency:delay_ms=50,rate=0.5"`` — rules are
        ``;``-separated, each ``site:key=val,key=val``; a bare ``seed=N``
        rule sets the plan seed.
        """
        specs: list[FaultSpec] = []
        seed = 0
        for part in filter(None, (p.strip() for p in text.split(";"))):
            if part.startswith("seed="):
                seed = int(part[5:])
                continue
            site, _, rest = part.partition(":")
            site = site.strip()
            if site not in SITES:
                raise ValueError(
                    f"RAVEN_FAULTS: unknown site {site!r} (sites: {SITES})"
                )
            kw: dict = {}
            for item in filter(None, (i.strip() for i in rest.split(","))):
                key, _, val = item.partition("=")
                if key in ("rate", "delay_ms"):
                    kw[key] = float(val)
                elif key in ("times", "after"):
                    kw[key] = int(val)
                elif key == "transient":
                    kw[key] = val.lower() not in ("0", "false", "no")
                elif key == "match":
                    kw[key] = val
                else:
                    raise ValueError(f"RAVEN_FAULTS: unknown key {key!r}")
            specs.append(FaultSpec(site=site, **kw))
        return cls(specs, seed=seed)


# -- process-wide installation (mirrors engine.set_artifact_store) -----------

_FAULT_PLAN: Optional[FaultPlan] = None
_ENV_PLAN: tuple[str, Optional[FaultPlan]] = ("", None)
_INSTALL_LOCK = threading.Lock()


def set_fault_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or clear, with None) the process-wide fault plan; returns
    the previous one."""
    global _FAULT_PLAN
    with _INSTALL_LOCK:
        prev, _FAULT_PLAN = _FAULT_PLAN, plan
    return prev


def get_fault_plan() -> Optional[FaultPlan]:
    """The installed plan, else one parsed from ``RAVEN_FAULTS`` (cached by
    env-string value), else None."""
    global _ENV_PLAN
    plan = _FAULT_PLAN
    if plan is not None:
        return plan
    text = os.environ.get("RAVEN_FAULTS", "")
    if not text:
        return None
    with _INSTALL_LOCK:
        if _ENV_PLAN[0] != text:
            _ENV_PLAN = (text, FaultPlan.parse(text))
        return _ENV_PLAN[1]


def maybe_inject(site: str, token: str = "") -> None:
    """Fault hook: no-op without a plan; with one, count the call and —
    when the matching spec fires — stall (``delay_ms``) or raise the typed
    injected error. Instrumented sites call this unconditionally; the
    no-plan path is one module-global read."""
    plan = get_fault_plan()
    if plan is None:
        return
    spec = plan.check(site, token)
    if spec is None:
        return
    if spec.delay_ms > 0:
        time.sleep(spec.delay_ms / 1e3)
        return
    if spec.transient:
        raise TransientFaultError(site, token)
    raise FaultInjectedError(site, token)


# -- retry policy ------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Group-retry policy for transient dispatch failures.

    A dispatched group that fails with a
    :class:`~repro_torch.errors.TransientError` is requeued whole (coalescing
    preserved) up to ``max_attempts`` total dispatches, with exponential
    backoff (``backoff_ms * multiplier**(attempt-1)``) plus deterministic
    jitter (a fraction of the base delay derived from the queue name and
    attempt index — no RNG, so schedules replay identically).
    ``deadline_ms`` bounds the total time since the oldest request in the
    group was submitted: once exceeded, the group fails terminally even if
    attempts remain."""

    max_attempts: int = 3
    backoff_ms: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.25
    deadline_ms: Optional[float] = None

    def delay_s(self, attempt: int, key: str = "") -> float:
        """Backoff before dispatch attempt ``attempt`` (attempt 0 = first
        try, never delayed)."""
        if attempt <= 0:
            return 0.0
        base = self.backoff_ms * (self.multiplier ** (attempt - 1))
        frac = _unit_hash("retry-jitter", key, attempt)
        return base * (1.0 + self.jitter * frac) / 1e3


# -- rollback policy ---------------------------------------------------------


@dataclass(frozen=True)
class RollbackPolicy:
    """Thresholds the registry's ``RollbackGuard`` watches on the live
    version after a cutover. All three signals come from the per-version
    ``VersionStats`` the server already collects; a None threshold disables
    that signal. ``min_requests`` gates judgement until the live version
    has served enough traffic to make the rates meaningful."""

    max_error_rate: Optional[float] = None      # errors / dispatch groups
    max_shadow_diff_rate: Optional[float] = None  # diff rows / shadow rows
    max_p99_ratio: Optional[float] = None       # p99 vs pre-cutover baseline
    min_requests: int = 8
