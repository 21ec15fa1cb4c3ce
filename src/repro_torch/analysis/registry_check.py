"""Registry state-machine checks: replay the model lifecycle's records.

The :class:`~repro_torch.serve.registry.ModelRegistry` *enforces* its state
machine at transition time; these checks *re-derive* the invariants from
the recorded evidence — every version's transition history, the live/shadow
pointers, and the server routes the registry tracks — so a bug that
corrupted state through a path the enforcement missed (or a future
refactor that forgets a transition) is caught by an independent reading,
not by the same code that made the mistake.

Three rules (see ``repro_torch.analysis.rules``):

  * ``registry-state`` — each version's history is a walk through
    ``ALLOWED_TRANSITIONS`` starting at ``published``, and each model has
    exactly one live version, the one its ``_live`` pointer routes to.
  * ``registry-route`` — registry and server agree: a tracked route's live
    and shadow labels match the registry's pointers, and every staged
    label on the route names a version the registry published.
  * ``registry-warm`` — no cutover went out cold: every route's last
    cutover recorded a zero warm deficit (``require_warm=False`` leaves
    the unwarmed ladder-entry count behind as evidence).

Three more rules audit the fault-tolerance layer riding the same
session: ``retry-state`` (scheduler redo bookkeeping), ``breaker-state``
(circuit-breaker/fallback consistency on every route version), and
``recovery-journal`` (the crash-recovery journal in the artifact store
agrees with the in-memory registry that wrote it).

Run standalone via :func:`check_registry` or as part of the
``python -m repro_torch.analysis`` gate's lifecycle scenario.
"""
from __future__ import annotations

from repro_torch.analysis.rules import (
    BREAKER_STATE,
    RECOVERY_JOURNAL,
    REGISTRY_ROUTE,
    REGISTRY_STATE,
    REGISTRY_WARM,
    RETRY_STATE,
    Violation,
)
from repro_torch.serve.registry import ALLOWED_TRANSITIONS


def check_registry(session) -> list[Violation]:
    """Audit a session's model registry against the recorded lifecycle
    evidence; returns one :class:`Violation` per broken invariant."""
    out: list[Violation] = []
    registry = session.models
    with registry._lock:
        snap = registry.snapshot()
        routes = {
            name: list(registry._routes.get(name, ()))
            for name in registry._versions
        }
    for name, model in sorted(snap.items()):
        out.extend(_check_state(name, model))
        out.extend(_check_routes(name, model, routes.get(name, [])))
    out.extend(check_fault_tolerance(session))
    return out


def check_fault_tolerance(session) -> list[Violation]:
    """Audit the session's retry/breaker/recovery bookkeeping (quiescent
    reads — run between flushes, like the rest of the gate)."""
    out: list[Violation] = []
    srv = getattr(session, "_server", None)
    if srv is not None:
        out.extend(_check_retry(srv))
        out.extend(_check_breaker(srv))
    out.extend(_check_journal(session))
    return out


def _check_retry(srv) -> list[Violation]:
    out: list[Violation] = []
    sch = srv.scheduler
    with sch._cv:
        redo_depth = 0
        for name, q in sch._queues.items():
            policy = q.retry if q.retry is not None else sch.default_retry
            for _group, attempt, _not_before in q.redo:
                redo_depth += 1
                if not 1 <= attempt < policy.max_attempts:
                    out.append(Violation(
                        RETRY_STATE.id,
                        f"redo entry carries attempt {attempt}, outside "
                        f"[1, {policy.max_attempts}) for this queue's "
                        f"RetryPolicy",
                        where=name,
                    ))
        if sch.retries < redo_depth:
            out.append(Violation(
                RETRY_STATE.id,
                f"{redo_depth} groups await re-dispatch but only "
                f"{sch.retries} retries were ever recorded",
                where="scheduler",
            ))
    return out


def _check_breaker(srv) -> list[Violation]:
    out: list[Violation] = []
    with srv._lock:
        regs = dict(srv.queries)
        for route in srv.routes.values():
            regs.update(
                (f"{route.name}:{label}", reg)
                for label, reg in route.versions.items()
            )
        trips = 0
        for where, reg in sorted(regs.items()):
            trips += reg.breaker_trips
            if reg.breaker_failures < 0:
                out.append(Violation(
                    BREAKER_STATE.id,
                    f"negative breaker failure count "
                    f"{reg.breaker_failures}",
                    where=where,
                ))
            if reg.fallback is not None and reg.breaker_trips < 1:
                out.append(Violation(
                    BREAKER_STATE.id,
                    "a fallback plan is installed but no breaker trip was "
                    "recorded",
                    where=where,
                ))
            if reg.degraded and reg.fallback is None:
                out.append(Violation(
                    BREAKER_STATE.id,
                    "registration is degraded with no fallback plan "
                    "compiled (trip claimed but never completed)",
                    where=where,
                ))
        # regs are shared between `queries` and route.versions (the live
        # label aliases the primary registration), so summed trips can
        # double-count aliases — the server total must never exceed it,
        # and must be positive whenever any registration tripped
        if trips and not srv.stats.breaker_trips:
            out.append(Violation(
                BREAKER_STATE.id,
                f"registrations record {trips} breaker trip(s) but the "
                f"server counted none",
                where="server",
            ))
    return out


def _check_journal(session) -> list[Violation]:
    store = getattr(session, "artifact_store", None)
    registry = session.models
    if store is None:
        return []
    if store.stats.registry_skipped:
        # a journal write was dropped (unpicklable state, by design
        # fail-soft) — the on-disk journal is known-stale, so disagreement
        # with the in-memory registry is expected, not a violation
        return []
    state = store.load_registry(session._journal_key())
    with registry._lock:
        snap = registry.snapshot()
        tracked = {
            name: sorted(r.serve_name for r in registry._routes.get(name, ()))
            for name in registry._versions
        }
    if state is None:
        if snap:
            return [Violation(
                RECOVERY_JOURNAL.id,
                f"registry holds models {sorted(snap)} but the artifact "
                f"store has no recovery journal for this session's tables",
                where="journal",
            )]
        return []
    out: list[Violation] = []
    jmodels = state.get("models", {})
    if sorted(jmodels) != sorted(snap):
        out.append(Violation(
            RECOVERY_JOURNAL.id,
            f"journal names models {sorted(jmodels)} but the registry "
            f"holds {sorted(snap)}",
            where="journal",
        ))
    for name in sorted(set(jmodels) & set(snap)):
        jrec, rec = jmodels[name], snap[name]
        for field in ("live", "shadow", "split"):
            if jrec.get(field) != rec[field]:
                out.append(Violation(
                    RECOVERY_JOURNAL.id,
                    f"journal {field}={jrec.get(field)!r} disagrees with "
                    f"the registry's {rec[field]!r}",
                    where=name,
                ))
        jstates = [(v["version"], v["state"]) for v in jrec.get("versions", ())]
        rstates = [(v["version"], v["state"]) for v in rec["versions"]]
        if jstates != rstates:
            out.append(Violation(
                RECOVERY_JOURNAL.id,
                f"journal version states {jstates} disagree with the "
                f"registry's {rstates}",
                where=name,
            ))
        jroutes = sorted(
            r["serve_name"] for r in state.get("routes", {}).get(name, ())
        )
        if jroutes != tracked.get(name, []):
            out.append(Violation(
                RECOVERY_JOURNAL.id,
                f"journal routes {jroutes} disagree with the tracked "
                f"routes {tracked.get(name, [])}",
                where=name,
            ))
    return out


def _check_state(name: str, model: dict) -> list[Violation]:
    out: list[Violation] = []
    for v in model["versions"]:
        ref = f"{name}@{v['version']}"
        hist = v["history"]
        if not hist or hist[0] != "published":
            out.append(Violation(
                REGISTRY_STATE.id,
                f"history does not start at 'published': {hist}",
                where=ref,
            ))
            continue
        for prev, nxt in zip(hist, hist[1:]):
            if nxt not in ALLOWED_TRANSITIONS.get(prev, frozenset()):
                out.append(Violation(
                    REGISTRY_STATE.id,
                    f"recorded transition {prev!r} -> {nxt!r} is not in the "
                    f"state machine (history: {hist})",
                    where=ref,
                ))
        if v["state"] != hist[-1]:
            out.append(Violation(
                REGISTRY_STATE.id,
                f"state {v['state']!r} disagrees with the last recorded "
                f"transition {hist[-1]!r}",
                where=ref,
            ))
    live_versions = [v["version"] for v in model["versions"]
                     if v["state"] == "live"]
    if len(live_versions) != 1:
        out.append(Violation(
            REGISTRY_STATE.id,
            f"expected exactly one live version, found "
            f"{live_versions or 'none'}",
            where=name,
        ))
    elif model["live"] != live_versions[0]:
        out.append(Violation(
            REGISTRY_STATE.id,
            f"live pointer routes to v{model['live']} but v"
            f"{live_versions[0]} holds the 'live' state",
            where=name,
        ))
    return out


def _check_routes(name: str, model: dict, routes: list) -> list[Violation]:
    out: list[Violation] = []
    live = model["live"]
    shadow = model["shadow"]
    known = {f"v{v['version']}" for v in model["versions"]}
    for rt in routes:
        where = f"{name}:{rt.serve_name}"
        route = rt.server.routes.get(rt.serve_name)
        if route is None:
            out.append(Violation(
                REGISTRY_ROUTE.id,
                "registry tracks a route the server no longer has",
                where=where,
            ))
            continue
        snap = rt.server.route_snapshot(rt.serve_name)
        if live is not None and snap["live"] != f"v{live}":
            out.append(Violation(
                REGISTRY_ROUTE.id,
                f"server routes live traffic to {snap['live']} but the "
                f"registry's live version is v{live}",
                where=where,
            ))
        want_shadow = None if shadow is None else f"v{shadow}"
        if snap["shadow"] != want_shadow:
            out.append(Violation(
                REGISTRY_ROUTE.id,
                f"server shadow {snap['shadow']!r} disagrees with the "
                f"registry's {want_shadow!r}",
                where=where,
            ))
        unknown = sorted(set(snap["versions"]) - known)
        if unknown:
            out.append(Violation(
                REGISTRY_ROUTE.id,
                f"route stages version labels the registry never "
                f"published: {unknown}",
                where=where,
            ))
        if snap["last_cutover_deficit"]:
            out.append(Violation(
                REGISTRY_WARM.id,
                f"last cutover went out cold: "
                f"{snap['last_cutover_deficit']} unwarmed ladder "
                f"entries (require_warm=False)",
                where=where,
            ))
    return out
