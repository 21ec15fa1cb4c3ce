"""Typed, message-bearing errors for the prediction-query front door.

The SQL frontend and session API raise these instead of leaking raw
``KeyError``/``IndexError`` from internal dict lookups, so callers can catch
one family (``RavenError``) or a specific failure mode.
``SQLSyntaxError`` also subclasses :class:`SyntaxError`.

The serving, lifecycle, fault and verifier types are defined here as in the
reference package, so that callers catch the same names; the port raises
them as the items that need them land (ROADMAP Queue 1 items 6-8).
"""
from __future__ import annotations


class RavenError(Exception):
    """Base class for all prediction-query API errors."""


class SQLSyntaxError(RavenError, SyntaxError):
    """Malformed query text (including a malformed PREDICT clause)."""


class UnknownModelError(RavenError):
    """PREDICT references a model name absent from the registry."""


class UnknownModelVersionError(UnknownModelError):
    """A ``name@version`` reference names a version never published.

    Subclasses :class:`UnknownModelError` so callers catching the model
    family see both; the message distinguishes "no such model" from "model
    exists, version doesn't"."""


class RegistryStateError(RavenError):
    """A model-lifecycle operation was attempted from an invalid state.

    Raised by the :class:`~repro_torch.serve.registry.ModelRegistry` when a
    transition violates the ``published → warming → ready → live → retired``
    state machine — e.g. cutting over to a version that is not warm
    (``cutover(require_warm=True)`` with cold buckets outstanding), staging
    a version whose scan columns are incompatible with the live route, or
    retiring the live version."""


class UnknownTableError(RavenError):
    """Query references a table absent from the database."""


class UnknownColumnError(RavenError):
    """Predicate or join key references a column no table provides."""


class UnboundParameterError(RavenError):
    """A ``:param`` placeholder was left unbound at prepare/execute time."""


class UnknownParameterError(RavenError):
    """``bind``/``rebind`` named a parameter the query does not declare."""


class UnknownQueryError(RavenError):
    """``submit``/``rebind`` named a query never registered with the server."""


class ServerOverloadedError(RavenError):
    """A bounded queue (``serve(max_pending=...)``) rejected a submit.

    Raised by ``submit(..., block=False)`` the moment a query's pending
    queue is full, or by a blocking submit whose ``timeout`` expired before
    the scheduler freed space. Backpressure instead of unbounded queueing:
    the caller sheds load (or retries) rather than the server accumulating
    an ever-deeper backlog it can never serve within its latency targets."""


class TransientError(RavenError):
    """A failure that is safe to retry: the request group is still intact
    and a re-dispatch of the same group may succeed (injected fault, dead
    scheduler worker, torn artifact read). The scheduler's retry policy
    only ever retries errors in this family — anything else is treated as
    deterministic and fails the group immediately."""


class FaultInjectedError(RavenError):
    """An error raised by the deterministic fault-injection harness.
    ``site`` names the injection point."""

    def __init__(self, site: str, token: str = ""):
        at = f" at {token}" if token else ""
        super().__init__(f"injected fault at site '{site}'{at}")
        self.site = site
        self.token = token


class TransientFaultError(FaultInjectedError, TransientError):
    """An injected fault marked retryable (``FaultSpec(transient=True)``)."""


class RequestTimeoutError(RavenError):
    """``QueryRequest.wait(timeout=...)`` expired before the request
    settled. The request itself is *not* cancelled — it may still complete
    (or fail) later; the caller can wait again."""


class RequestFailedError(RavenError):
    """Terminal serving failure delivered to every waiter in a dispatch
    group: the group's retries are exhausted (or the error was never
    retryable) and the request will not produce a result. ``attempts``
    counts dispatch attempts; the underlying error is ``__cause__``."""

    def __init__(self, message: str, attempts: int = 1):
        super().__init__(message)
        self.attempts = attempts


class RecoveryError(RavenError):
    """``Session.recover()`` could not restore the registry from disk —
    no journal exists under this registry fingerprint, the journal was
    quarantined as corrupt, or it was written by an incompatible store."""


class PlanVerificationError(RavenError):
    """The static plan verifier rejected a plan (``verify='strict'``).

    Carries the typed :class:`Violation` list in
    ``violations`` — each names the rule that fired and, for differential
    checks, the optimizer rewrite rule that introduced the breakage."""

    def __init__(self, message: str, violations=None):
        super().__init__(message)
        self.violations = list(violations or [])


class StaleQueryError(RavenError):
    """A served handle no longer matches the registration under its name.

    Raised when ``PreparedQuery.submit`` (or ``QueryServer.submit`` with
    ``expect_token``) targets a name that has since been re-registered —
    with a different physical plan *or* different bound parameter values
    (plan fingerprints are deliberately param-invariant, so the guard keys
    on the registration itself) — serving through the stale handle would
    silently answer with the wrong query."""


def check_params(
    declared, bound, *, require_all: bool = True, context: str = "query"
) -> None:
    """Validate a parameter binding against a query's declared ``:params``.

    ``require_all=True`` (prepare/register) demands every declared parameter
    is bound; ``require_all=False`` (bind/rebind) allows partial re-binds.
    Unknown names are always rejected.
    """
    declared, bound = set(declared), set(bound)
    if require_all:
        missing = declared - bound
        if missing:
            raise UnboundParameterError(
                f"{context} has unbound parameters {sorted(missing)} — "
                f"bind them via params={{...}}"
            )
    unknown = bound - declared
    if unknown:
        raise UnknownParameterError(
            f"{context} declares no parameters {sorted(unknown)}; "
            f"its parameters are {sorted(declared) or '(none)'}"
        )
