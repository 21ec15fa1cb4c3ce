"""Typed rule registry for the plan verifier and the concurrency lint.

Every check the analysis layer performs is a named :class:`Rule`; every
failure is a :class:`Violation` carrying the rule id, so diagnostics are
greppable ("which rule fired?") and tests can assert a *specific* rule
rejected a *specific* corruption. Rules are grouped by scope:

  * ``logical`` — invariants of the logical plan / PredictionQuery, checked
    differentially after every optimizer rewrite rule;
  * ``graph``   — structural invariants of the lowered :class:`StageGraph`;
  * ``exec``    — abstract-execution invariants (each pure stage run on
    zero-filled inputs at two shape buckets: schema, dtypes,
    row-polymorphism);
  * ``lint``    — static source checks (lock discipline, forbidden
    patterns), independent of any particular plan.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Rule:
    """One named invariant the analysis layer enforces."""

    id: str
    scope: str  # "logical" | "graph" | "exec" | "lint" | "registry"
    description: str


@dataclass
class Violation:
    """One rule failure: the rule id, where it fired, and why."""

    rule: str
    message: str
    # context: a stage label, optimizer rewrite-rule name, or file:line
    where: str = ""

    def __str__(self) -> str:
        loc = f" {self.where}:" if self.where else ""
        return f"[{self.rule}]{loc} {self.message}"


class VerificationWarning(UserWarning):
    """Raised as a warning (``verify='warn'``) instead of an error."""


_REGISTRY: dict[str, Rule] = {}


def register(rule_id: str, scope: str, description: str) -> Rule:
    rule = Rule(rule_id, scope, description)
    if rule_id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule_id!r}")
    _REGISTRY[rule_id] = rule
    return rule


def rule_catalog() -> list[Rule]:
    """All registered rules, in registration order (docs + CLI listing)."""
    return list(_REGISTRY.values())


def violation(rule: Rule, message: str, where: str = "") -> Violation:
    return Violation(rule=rule.id, message=message, where=where)


# -- verifier rules ----------------------------------------------------------

GRAPH_SHAPE = register(
    "graph-shape", "graph",
    "stage indices are contiguous, kinds valid, pure stages carry a fn and "
    "host stages exactly one MLUdf, no two adjacent pure stages",
)
SCHEMA_CHAIN = register(
    "schema-chain", "graph",
    "declared stage schemas chain: each stage's in_columns match the "
    "upstream stage's out_columns and its out_columns match re-inference",
)
CONSUMES_BALANCE = register(
    "consumes-balance", "graph",
    "every produced __pv_* block column is consumed exactly once "
    "downstream, by an operator that actually reads it",
)
BLOCK_LEAK = register(
    "block-leak", "graph",
    "no reserved __pv_* block column reaches the query output schema",
)
PLACEMENT_PURE = register(
    "placement-pure", "graph",
    "pure stages contain only torch-executable operators; host stages "
    "contain exactly the MLUdf boundary",
)
RESIDUAL_MINIMAL = register(
    "residual-minimal", "graph",
    "split-lowered MLUdf residuals are minimal: re-splitting the residual "
    "against tensor_supported yields no further prefix or suffix",
)
FINGERPRINT_STABLE = register(
    "fingerprint-stable", "graph",
    "re-lowering the plan reproduces every chained stage fingerprint, and "
    "no fingerprint token embeds a memory-address repr",
)
FINGERPRINT_DETERMINISTIC = register(
    "fingerprint-deterministic", "graph",
    "the plan fingerprint is content-addressed: rebuilding the plan from "
    "fresh node/container objects does not change it",
)

SCHEMA_EXEC = register(
    "schema-exec", "exec",
    "abstract execution (a zero-filled run) of each pure stage succeeds and "
    "produces exactly the declared out_columns (host stages run on a "
    "zero-row batch)",
)
SCHEMA_DTYPE = register(
    "schema-dtype", "exec",
    "output dtypes are bucket-invariant and the validity mask is boolean",
)
BUCKET_SAFETY = register(
    "bucket-safety", "exec",
    "pure stages are row-polymorphic: output leading dims either scale "
    "with the row bucket or are bucket-independent, so warm re-bucketing "
    "cannot retrace",
)
SEGMENT_THREADING = register(
    "segment-threading", "exec",
    "segment ids survive to the end of the graph whenever the graph needs "
    "them (host boundaries or aggregates under coalesced serving)",
)

PIPELINE_GRAPH = register(
    "pipeline-graph", "logical",
    "every LPredict pipeline is an acyclic single-producer DAG whose "
    "declared outputs are actually produced",
)
LOGICAL_SCHEMA = register(
    "logical-schema", "logical",
    "every logical operator references only columns its child provides",
)

# -- lint rules --------------------------------------------------------------

LOCK_ORDER = register(
    "lock-order", "lint",
    "the lock-acquisition graph (with one-level call edges) is acyclic — "
    "no lock-order inversions",
)
LOCK_REENTRY = register(
    "lock-reentry", "lint",
    "a non-reentrant threading.Lock is never re-acquired while held",
)
UNLOCKED_MUTATION = register(
    "unlocked-mutation", "lint",
    "no instance field is mutated both inside and outside a lock "
    "(outside __init__; helpers only ever called under a lock inherit it)",
)
FINGERPRINT_HYGIENE_SRC = register(
    "fingerprint-hygiene-src", "lint",
    "__fingerprint_token__ assignments are content-addressed: no id()/"
    "repr()/hash()/time.* and no interpolated f-strings in the token",
)
HOST_IN_JIT = register(
    "host-in-jit", "lint",
    "no host callbacks (numpy, time, print) inside jitted stage bodies",
)
WALLCLOCK_TIMING = register(
    "wallclock-timing", "lint",
    "runtime code measures durations with perf_counter/monotonic, never "
    "time.time() (wall clock steps under NTP)",
)

# -- model-registry rules ----------------------------------------------------

REGISTRY_STATE = register(
    "registry-state", "registry",
    "every model version's recorded history follows the published → "
    "warming → ready → live → retired state machine, and each model has "
    "exactly one live version (the registry's routing target)",
)
REGISTRY_ROUTE = register(
    "registry-route", "registry",
    "registry and server agree: every tracked route's live/shadow labels "
    "match the registry's live/shadow versions, and every staged label on "
    "a server route is a version the registry knows",
)
REGISTRY_WARM = register(
    "registry-warm", "registry",
    "no cutover was forced cold: every route's last cutover had zero "
    "unwarmed ladder entries (require_warm=False leaves a recorded deficit)",
)

# -- fault-tolerance rules ---------------------------------------------------

RETRY_STATE = register(
    "retry-state", "serving",
    "scheduler retry accounting is sane: cumulative retries bound the "
    "pending redo depth, and every queued redo entry's attempt count is "
    "positive and below its queue's RetryPolicy max_attempts",
)
BREAKER_STATE = register(
    "breaker-state", "serving",
    "circuit-breaker state is consistent on every route version: a "
    "degraded version has a compiled fallback plan (fingerprint-forked "
    "from the primary), failure counts stay below the trip threshold "
    "unless degraded, and trip counts never exceed recorded failures",
)
RECOVERY_JOURNAL = register(
    "recovery-journal", "registry",
    "the crash-recovery journal agrees with the in-memory registry: "
    "live/shadow/split pointers, version counts and states, and tracked "
    "route names in the journal match the registry that wrote it",
)


@dataclass
class AnalysisResult:
    """Outcome of one analysis pass (verifier run or lint run)."""

    violations: list[Violation] = field(default_factory=list)
    # one line per check group that ran clean, for reporting
    passed: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def extend(self, other: "AnalysisResult") -> None:
        self.violations.extend(other.violations)
        self.passed.extend(other.passed)

    def describe(self) -> str:
        lines = [str(v) for v in self.violations]
        lines += [f"ok: {p}" for p in self.passed]
        return "\n".join(lines)
