"""Versioned model lifecycle: publish → warm → shadow/split → cutover.

Serving froze one model per registration: shipping model v2 meant
re-registering, which mints a new token and stales every outstanding
handle (:class:`~repro_torch.errors.StaleQueryError`) — correct for a
*different query*, hostile for *the same query with a newer model*. The
:class:`ModelRegistry` is the production story on top of the machinery
that already exists — content fingerprints, the artifact store's warm
starts, and the server's versioned :class:`~repro_torch.serve.query_server.QueryRoute`:

    db = raven.connect(tables, stats="auto")      # the card, or device="cpu"
    v1 = db.models.publish("risk", pipe)          # version handle (live)
    prep = db.sql("... PREDICT(model='risk' ...)").prepare().serve("q")

    v2 = db.models.publish("risk", pipe2)         # staged + warm-compiled
    v2.wait_ready()                               #   (background by default)
    db.models.shadow("risk", 2)                   # mirrored, diffed, counted
    db.models.split("risk", {2: 0.25})            # every 4th group on v2
    db.models.cutover("risk", 2)                  # atomic: zero dropped,
                                                  #   zero captured requests
    db.models.retire("risk", 1)

Every version moves through an explicit state machine — ``published →
warming → ready → live → retired`` — whose recorded history the
``registry-state`` analysis rule replays. Publishing onto a model with
served routes stages the new version onto each route (same query IR,
re-optimized for the new pipeline — new weights are a new fingerprint,
so plan/stage caches never collide) and replays the route's observed
bucket ladder through it, so by ``ready`` the incoming version holds a
captured graph for every shape live traffic uses.

``PREDICT(model=...)`` references resolve through one documented path,
:meth:`ModelRegistry.resolve`:

    ``"name"``          the live version (what production traffic gets)
    ``"name@2"``        that exact published version
    ``"name@latest"``   the newest published version
    ``"name@live"``     explicit spelling of the default
    ``"name@shadow"``   the version currently shadowed (error if none)

The registry implements the mapping protocol the SQL frontend already
uses for the plain model dict (``in`` / ``[]`` / iteration), so the
parser did not change: ``models[spec.model]`` now returns the resolved
version's pipeline and raises the precise
:class:`~repro_torch.errors.UnknownModelVersionError` /
:class:`~repro_torch.errors.RegistryStateError` instead of a generic miss.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

from repro_torch.errors import (
    RecoveryError,
    RegistryStateError,
    UnknownModelError,
    UnknownModelVersionError,
)
from repro_torch.exec.faults import RollbackPolicy

# the recorded-history state machine the registry-state rule replays
ALLOWED_TRANSITIONS: dict[str, frozenset] = {
    "published": frozenset({"warming", "ready", "live", "retired"}),
    "warming": frozenset({"ready", "live", "retired"}),
    "ready": frozenset({"live", "retired"}),
    "live": frozenset({"ready", "retired"}),
    "retired": frozenset(),
}


class ModelVersion:
    """One published version of a named model: pipeline + fingerprint +
    lifecycle state. Returned by :meth:`ModelRegistry.publish`."""

    def __init__(self, name: str, version: int, pipeline, fingerprint: str):
        self.name = name
        self.version = version
        self.pipeline = pipeline
        self.fingerprint = fingerprint
        self.state = "published"
        self.history: list[str] = ["published"]
        self.events: list[str] = []  # lifecycle decisions (e.g. rollbacks)
        self.error: Optional[BaseException] = None  # warm-compile failure
        self._ready = threading.Event()

    @property
    def ref(self) -> str:
        """The canonical ``name@version`` reference for this version."""
        return f"{self.name}@{self.version}"

    @property
    def label(self) -> str:
        """The version label used on server routes (``v<version>``)."""
        return f"v{self.version}"

    def wait_ready(self, timeout: Optional[float] = None) -> "ModelVersion":
        """Block until background warm-compile finished (or failed: the
        contained error re-raises here, wrapped)."""
        if not self._ready.wait(timeout):
            raise RegistryStateError(
                f"version {self.ref} not ready within {timeout}s"
            )
        if self.error is not None:
            raise RegistryStateError(
                f"warm-compile of {self.ref} failed: {self.error}"
            ) from self.error
        return self

    def _transition(self, new: str) -> None:
        if new == self.state:
            return
        if new not in ALLOWED_TRANSITIONS[self.state]:
            raise RegistryStateError(
                f"{self.ref}: illegal state transition "
                f"{self.state!r} -> {new!r}"
            )
        self.state = new
        self.history.append(new)

    def __repr__(self) -> str:
        return (
            f"ModelVersion({self.ref}, state={self.state!r}, "
            f"fingerprint={self.fingerprint[:12]}…)"
        )


@dataclasses.dataclass
class _Route:
    """One served query whose PREDICT references a registered model."""

    serve_name: str
    prep: Any       # the PreparedQuery that served it (options + params)
    server: Any     # the PredictionQueryServer owning the route


class ModelRegistry:
    """Names → ordered published versions, plus the routes serving them.

    All state lives under one reentrant lock (lifecycle methods call each
    other: ``publish`` warms, ``cutover`` resolves); the slow work —
    optimizing and warm-compiling an incoming version — happens *outside*
    it, on the publishing (or a background) thread, so serving never
    stalls behind a publish.
    """

    def __init__(self, session):
        self._session = session
        self._lock = threading.RLock()
        self._versions: dict[str, list[ModelVersion]] = {}
        self._live: dict[str, int] = {}
        self._shadow: dict[str, int] = {}
        self._split: dict[str, dict[int, float]] = {}  # active split state
        self._routes: dict[str, list[_Route]] = {}  # model name -> routes
        self._pins: list[Any] = []  # identity-hashed pipeline components
        # rollback machinery: per-model pre-cutover baseline (previous live
        # version + its p99), recorded decisions, and running guards
        self._baselines: dict[str, dict[str, Any]] = {}
        self._rollbacks: list[dict[str, Any]] = []
        self._guards: list["RollbackGuard"] = []

    # -- publish -------------------------------------------------------------

    def publish(self, name: str, pipe_or_path, *, warm: str = "background"):
        """Publish a pipeline (or saved-pipeline path) as the next version
        of ``name``; returns the :class:`ModelVersion` handle.

        The first version of a name goes live immediately — it *is* the
        model. Later versions are staged: when the model has served routes,
        the new version is compiled onto each route and the route's
        observed bucket ladder replayed through it (``warm="background"``
        on a daemon thread — ``handle.wait_ready()`` joins it;
        ``warm="sync"`` inline; ``warm="off"`` defers both to
        :meth:`shadow`/:meth:`split`/:meth:`cutover` time, which warm
        lazily). A warm failure never disturbs serving: it is contained on
        the handle (``error``, state ``retired``) and re-raised only by
        ``wait_ready()``.
        """
        if warm not in ("background", "sync", "off"):
            raise RegistryStateError(
                f"warm must be 'background', 'sync', or 'off' — got {warm!r}"
            )
        if isinstance(pipe_or_path, str):
            from repro_torch.ml.pipeline import load_pipeline

            pipe_or_path = load_pipeline(pipe_or_path)
        from repro_torch.core.fingerprint import fingerprint

        with self._lock:
            versions = self._versions.setdefault(name, [])
            number = len(versions) + 1
            fp = fingerprint(
                "model-version", name, number, pipe_or_path, pins=self._pins
            )
            mv = ModelVersion(name, number, pipe_or_path, fp)
            versions.append(mv)
            if number == 1:
                mv._transition("live")
                self._live[name] = 1
                mv._ready.set()
                self._journal()
                return mv
        if warm == "off":
            mv._ready.set()
            self._journal()
            return mv
        if warm == "sync":
            self._warm(mv)
        else:
            threading.Thread(
                target=self._warm, args=(mv,),
                name=f"registry-warm-{mv.ref}", daemon=True,
            ).start()
        return mv

    def _warm(self, mv: ModelVersion) -> None:
        """Stage ``mv`` onto every tracked route and replay each route's
        bucket ladder through it (runs on the publisher or a warm thread)."""
        try:
            mv._transition("warming")
            for rt in self._routes_for(mv.name):
                self._stage_on_route(mv, rt)
                rt.server.warm_version(rt.serve_name, mv.label)
            mv._transition("ready")
        except BaseException as e:  # noqa: BLE001 — contained on the handle
            mv.error = e
            mv._transition("retired")
        finally:
            # journal BEFORE releasing waiters: once wait_ready() returns,
            # the caller may shadow/split/cutover and journal — a background
            # warm thread journaling afterwards would overwrite that newer
            # state with this stale one
            try:
                self._journal()
            finally:
                mv._ready.set()

    def _stage_on_route(self, mv: ModelVersion, rt: _Route) -> None:
        """Compile ``mv`` as a staged version on one served route: same
        query spec re-pointed at ``name@version``, re-optimized (new
        weights are a new fingerprint — plan/stage caches cannot collide
        with the live version's), registered via the server's
        ``stage_version`` so the submit-schema compatibility checks run."""
        route = rt.server.routes.get(rt.serve_name)
        if route is not None and mv.label in route.versions:
            return  # already staged (e.g. shadow before cutover)
        prep = rt.prep
        spec = dataclasses.replace(prep.query.spec, model=mv.ref)
        q = type(prep.query)(self._session, spec)
        plan, report = q._optimize(prep.options, prep.strategy)
        rt.server.stage_version(
            rt.serve_name, q.ir, self._session.database,
            version_label=mv.label, optimized=(plan, report),
            params=prep.params,
        )

    def _ensure_staged(self, mv: ModelVersion) -> None:
        """Lazily stage + warm a version published with ``warm='off'`` (or
        routes served after it was published)."""
        if mv.state == "retired":
            raise RegistryStateError(
                f"{mv.ref} is retired"
                + (f" (warm-compile failed: {mv.error})" if mv.error else "")
            )
        if mv.state == "warming":
            # a background publish is mid-warm: join it rather than racing
            # it onto the same routes
            mv.wait_ready(timeout=600.0)
        missing = [
            rt for rt in self._routes_for(mv.name)
            if mv.label not in rt.server.routes[rt.serve_name].versions
        ]
        for rt in missing:
            self._stage_on_route(mv, rt)
            rt.server.warm_version(rt.serve_name, mv.label)
        if mv.state == "published":
            mv._transition("warming")
            mv._transition("ready")

    def _routes_for(self, name: str) -> list[_Route]:
        with self._lock:
            return list(self._routes.get(name, ()))

    def _track_route(self, model_ref: str, serve_name: str, prep, server) -> None:
        """Record that a served query's PREDICT references ``model_ref``
        (called by ``PreparedQuery.serve``); lifecycle operations fan out
        over these routes."""
        name, _ = self._parse_ref(model_ref)
        with self._lock:
            if name not in self._versions:
                return
            routes = self._routes.setdefault(name, [])
            routes[:] = [r for r in routes if r.serve_name != serve_name]
            routes.append(_Route(serve_name, prep, server))
        self._journal()

    # -- lifecycle -----------------------------------------------------------

    def shadow(self, name: str, version: Optional[int]) -> None:
        """Mirror live traffic for ``name`` through ``version`` on every
        route: scored on copies of the same coalesced groups, diffed
        against the returned results, counted in per-version stats — and
        never returned. ``None`` stops shadowing."""
        if version is None:
            with self._lock:
                self._shadow.pop(name, None)
            for rt in self._routes_for(name):
                rt.server.set_shadow(rt.serve_name, None)
            self._journal()
            return
        mv = self._get_version(name, version)
        self._ensure_staged(mv)
        for rt in self._routes_for(name):
            rt.server.set_shadow(rt.serve_name, mv.label)
        with self._lock:
            self._shadow[name] = version
        self._journal()

    def split(self, name: str, fractions: dict[int, float]) -> None:
        """Send a deterministic fraction of dispatched groups to staged
        versions (``{version: fraction}``; the live version serves the
        remainder); ``{}`` clears the split."""
        regs = {}
        for version, frac in fractions.items():
            mv = self._get_version(name, int(version))
            self._ensure_staged(mv)
            regs[mv.label] = float(frac)
        for rt in self._routes_for(name):
            rt.server.set_split(rt.serve_name, regs)
        with self._lock:
            if fractions:
                self._split[name] = {
                    int(v): float(f) for v, f in fractions.items()
                }
            else:
                self._split.pop(name, None)
        self._journal()

    def cutover(
        self, name: str, version: int, *, require_warm: bool = True
    ) -> ModelVersion:
        """Atomically make ``version`` the live model for ``name``.

        Every route swaps under its scheduler's hold — in-flight groups
        finish on the version that dispatched them (zero dropped), groups
        popped afterwards run the new version, and with ``require_warm``
        (default) the swap also captures nothing (the incoming version must
        have replayed the route's full bucket ladder and kept its graphs). Outstanding submit
        handles keep working: the route token does not change. Fresh
        ``PREDICT(model='name')`` queries resolve to the new version from
        this call on."""
        mv = self._get_version(name, version)
        with self._lock:
            if self._live.get(name) == version:
                raise RegistryStateError(f"{mv.ref} is already live")
            outgoing = self._live.get(name)
        self._ensure_staged(mv)
        # pre-cutover baseline for the rollback guard: the outgoing live
        # version's p99 over each route's rolling latency window, captured
        # before any traffic reaches the incoming version
        baseline_p99 = 0.0
        if outgoing is not None:
            out_label = f"v{outgoing}"
            for rt in self._routes_for(name):
                snap = rt.server.route_snapshot(rt.serve_name)
                v = snap["versions"].get(out_label)
                if v is not None:
                    baseline_p99 = max(baseline_p99, v["p99_ms"])
        for rt in self._routes_for(name):
            rt.server.cutover(
                rt.serve_name, mv.label, require_warm=require_warm
            )
        with self._lock:
            old = self._live.get(name)
            self._live[name] = version
            if self._shadow.get(name) == version:
                del self._shadow[name]
            split = self._split.get(name)
            if split is not None and split.pop(version, None) is not None:
                if not split:
                    del self._split[name]
            if old is not None:
                self._versions[name][old - 1]._transition("ready")
                self._baselines[name] = {"prev": old, "p99_ms": baseline_p99}
            mv._transition("live")
        self._journal()
        return mv

    def retire(self, name: str, version: int) -> None:
        """Drop a non-live version: its route registrations are removed
        (refused while it still takes shadow/split traffic) and its state
        machine terminates."""
        mv = self._get_version(name, version)
        with self._lock:
            if self._live.get(name) == version:
                raise RegistryStateError(
                    f"cannot retire live version {mv.ref} — cut over to "
                    f"another version first"
                )
            if self._shadow.get(name) == version:
                raise RegistryStateError(
                    f"{mv.ref} is the active shadow — shadow(name, None) first"
                )
        doomed: set[str] = set()
        servers: list[Any] = []
        for rt in self._routes_for(name):
            servers.append(rt.server)
            route = rt.server.routes.get(rt.serve_name)
            if route is not None and mv.label in route.versions:
                reg = route.versions[mv.label]
                doomed |= {
                    st.fingerprint for st in reg.compiled.graph.stages
                }
                rt.server.retire_version(rt.serve_name, mv.label)
        with self._lock:
            mv._transition("retired")
        self._gc_retired(doomed, servers)
        self._journal()

    def _gc_retired(self, doomed: set, servers: list) -> None:
        """Garbage-collect a retired version's stage artifacts from the
        artifact store through the existing ``prune`` machinery — minus any
        stage fingerprint a still-registered version shares (structural
        sharing is real: a pre-model stage unchanged across versions keeps
        its fingerprint, and its on-disk programs stay warm)."""
        store = getattr(self._session, "artifact_store", None)
        if store is None or not doomed:
            return
        live_fps: set[str] = set()
        for srv in {id(s): s for s in servers}.values():
            for route in srv.routes.values():
                for reg in route.versions.values():
                    live_fps |= {
                        st.fingerprint for st in reg.compiled.graph.stages
                    }
        keys = doomed - live_fps
        if keys:
            store.prune(keys=keys)

    # -- automated rollback --------------------------------------------------

    def rollback(self, name: str, *, reason: str = "operator") -> ModelVersion:
        """Cut the live model back to the version it replaced.

        The reverse swap rides the exact cutover machinery forward swaps
        use — every route flips under its scheduler's hold, so zero
        requests are dropped — and the outgoing-at-rollback version's warm
        deficit is closed first (``warm_version`` replays only ladder
        entries the restored version has not covered), so the rollback is
        also captures nothing. The decision is recorded on both versions'
        ``events`` and in the registry's rollback log (journaled, surfaced
        by ``snapshot()`` and ``explain()``)."""
        with self._lock:
            live = self._live.get(name)
            base = self._baselines.get(name) or {}
            prev = base.get("prev")
        if live is None or prev is None or prev == live:
            raise RegistryStateError(
                f"model '{name}' has no previous live version to roll back "
                f"to — rollback needs a completed cutover first"
            )
        prev_mv = self._get_version(name, prev)
        bad_mv = self._get_version(name, live)
        # close any warm deficit the restored version accrued while demoted
        # (buckets first seen after the cutover), so the reverse swap
        # captures nothing
        for rt in self._routes_for(name):
            route = rt.server.routes.get(rt.serve_name)
            if route is not None and prev_mv.label in route.versions:
                rt.server.warm_version(rt.serve_name, prev_mv.label)
        self.cutover(name, prev, require_warm=True)
        with self._lock:
            # the cutover above recorded the *bad* version as the new
            # baseline "prev" — drop it, or an auto-guard could ping-pong
            # right back. Rollback is one-shot until the next forward
            # cutover records a fresh baseline.
            self._baselines.pop(name, None)
            bad_mv.events.append(f"rolled back to v{prev}: {reason}")
            prev_mv.events.append(
                f"restored live by rollback from v{live}: {reason}"
            )
            self._rollbacks.append(
                {"model": name, "from": live, "to": prev, "reason": reason}
            )
        self._journal()
        return prev_mv

    def check_rollback(
        self, name: str, policy: Optional[RollbackPolicy] = None
    ) -> Optional[ModelVersion]:
        """Evaluate the rollback policy against the live version's serving
        stats (aggregated over every route) and roll back on a breach.

        Returns the restored :class:`ModelVersion` when a rollback
        happened, else None. The three signals come from counters the
        server already keeps: per-version dispatch error rate (errors count
        even when the scheduler retried the group to success — detection
        fires before users see failures), the shadow diff-row rate observed
        while the version was mirrored, and the rolling p99 against the
        pre-cutover baseline recorded at swap time. ``policy=None`` uses
        ``ConnectOptions.rollback``; with neither, this is a no-op."""
        if policy is None:
            copts = getattr(self._session, "connect_options", None)
            policy = getattr(copts, "rollback", None)
        if policy is None:
            return None
        with self._lock:
            live = self._live.get(name)
            base = dict(self._baselines.get(name) or {})
        if live is None or base.get("prev") is None:
            return None
        label = f"v{live}"
        groups = requests = errors = 0
        sh_rows = sh_diff = 0
        p99 = 0.0
        for rt in self._routes_for(name):
            snap = rt.server.route_snapshot(rt.serve_name)
            v = snap["versions"].get(label)
            if v is None:
                continue
            groups += v["groups"]
            requests += v["requests"]
            errors += v["errors"]
            sh_rows += v["shadow_rows"]
            sh_diff += v["shadow_diff_rows"]
            p99 = max(p99, v["p99_ms"])
        if requests < policy.min_requests:
            return None
        reasons = []
        if policy.max_error_rate is not None and groups:
            rate = errors / groups
            if rate > policy.max_error_rate:
                reasons.append(
                    f"error rate {rate:.3f} > {policy.max_error_rate}"
                )
        if policy.max_shadow_diff_rate is not None and sh_rows:
            rate = sh_diff / sh_rows
            if rate > policy.max_shadow_diff_rate:
                reasons.append(
                    f"shadow diff rate {rate:.4f} > "
                    f"{policy.max_shadow_diff_rate}"
                )
        if policy.max_p99_ratio is not None and base.get("p99_ms", 0.0) > 0.0:
            ratio = p99 / base["p99_ms"]
            if ratio > policy.max_p99_ratio:
                reasons.append(
                    f"p99 {p99:.2f}ms is {ratio:.2f}x the pre-cutover "
                    f"baseline {base['p99_ms']:.2f}ms"
                )
        if not reasons:
            return None
        return self.rollback(name, reason="; ".join(reasons))

    def guard(
        self,
        name: str,
        policy: Optional[RollbackPolicy] = None,
        *,
        interval_s: float = 0.25,
        start: bool = True,
    ) -> "RollbackGuard":
        """Create (and by default start) a :class:`RollbackGuard` watching
        ``name``'s live version; ``session.close()`` stops it."""
        g = RollbackGuard(self, name, policy, interval_s=interval_s)
        with self._lock:
            self._guards.append(g)
        if start:
            g.start()
        return g

    def close(self) -> None:
        """Stop every running rollback guard (called by ``Session.close``)."""
        with self._lock:
            guards, self._guards = list(self._guards), []
        for g in guards:
            g.stop()

    # -- crash-safe journal + recovery ---------------------------------------

    def _journal(self) -> None:
        """Persist the registry's route/version topology through the
        artifact store (atomic single-file rewrite keyed on the session's
        table-schema fingerprint). Called after every lifecycle mutation;
        fail-soft by design — an unpicklable pipeline or absent store skips
        the write (counted on ``StoreStats.skipped``), never breaks the
        mutation itself."""
        store = getattr(self._session, "artifact_store", None)
        if store is None:
            return
        store.save_registry(self._session._journal_key(), self._journal_state())

    def _journal_state(self) -> dict[str, Any]:
        with self._lock:
            models: dict[str, Any] = {}
            for name, versions in self._versions.items():
                models[name] = {
                    "live": self._live.get(name),
                    "shadow": self._shadow.get(name),
                    "split": dict(self._split.get(name, {})),
                    "baseline": dict(self._baselines.get(name, {})),
                    "versions": [
                        {
                            "version": mv.version,
                            "state": mv.state,
                            "history": list(mv.history),
                            "events": list(mv.events),
                            "fingerprint": mv.fingerprint,
                            "pipeline": mv.pipeline,
                            "error": str(mv.error) if mv.error else None,
                        }
                        for mv in versions
                    ],
                }
            routes: dict[str, list] = {}
            for name, rts in self._routes.items():
                routes[name] = []
                for rt in rts:
                    prep = rt.prep
                    route = rt.server.routes.get(rt.serve_name)
                    routes[name].append({
                        "serve_name": rt.serve_name,
                        "spec": prep.query.spec,
                        "params": dict(prep.params),
                        "options": prep.options,
                        "strategy": prep.strategy,
                        "serve_options": prep._serve_options,
                        "ladder": sorted(route.ladder) if route else [],
                    })
            return {
                "models": models,
                "routes": routes,
                "rollbacks": list(self._rollbacks),
            }

    def _restore(self, state: dict[str, Any]) -> dict[str, Any]:
        """Rebuild registry + serving topology from a recovered journal
        (the implementation behind :meth:`Session.recover`). Versions and
        pointers are restored verbatim; each journaled route is re-prepared
        (a plan-layer disk hit — no re-optimization), re-served under its
        original name and options, its observed bucket ladder restored, and
        the live version warm-replayed — so the recovered server answers on
        previously-seen shapes with no new capture on the request path."""
        counts: dict[str, Any] = {
            "models": 0, "versions": 0, "routes": 0, "skipped": [],
        }
        with self._lock:
            if self._versions:
                raise RecoveryError(
                    "recover() must run on a fresh session — this registry "
                    f"already holds models {sorted(self._versions)}"
                )
            for name, rec in state.get("models", {}).items():
                versions: list[ModelVersion] = []
                for vrec in rec.get("versions", ()):
                    mv = ModelVersion(
                        name, vrec["version"], vrec["pipeline"],
                        vrec["fingerprint"],
                    )
                    mv.state = vrec["state"]
                    mv.history = list(vrec["history"])
                    mv.events = list(vrec.get("events", ()))
                    mv._ready.set()
                    versions.append(mv)
                    counts["versions"] += 1
                self._versions[name] = versions
                if rec.get("live") is not None:
                    self._live[name] = rec["live"]
                if rec.get("shadow") is not None:
                    self._shadow[name] = rec["shadow"]
                if rec.get("split"):
                    self._split[name] = dict(rec["split"])
                if rec.get("baseline"):
                    self._baselines[name] = dict(rec["baseline"])
                counts["models"] += 1
            self._rollbacks = list(state.get("rollbacks", ()))
        # re-serve journaled routes outside the lock (optimize-from-disk +
        # compile + warm-start are the slow part); one broken route is
        # skipped and reported, not fatal to the rest
        for name, rts in state.get("routes", {}).items():
            for rrec in rts:
                try:
                    self._restore_route(name, rrec)
                    counts["routes"] += 1
                except BaseException as e:  # noqa: BLE001 — fail-soft per route
                    counts["skipped"].append(
                        f"{rrec.get('serve_name', '?')}: {e}"
                    )
        # re-apply the mirrored/split topology onto the restored routes
        for name in list(state.get("models", {})):
            shadow = self._shadow.get(name)
            if shadow is not None and name in self._versions:
                self.shadow(name, shadow)
            split = self._split.get(name)
            if split:
                self.split(name, dict(split))
        return counts

    def _restore_route(self, model_name: str, rrec: dict[str, Any]) -> None:
        """Re-serve one journaled route: prepare (disk plan tier), serve
        under the original name/options, restore the bucket ladder, and
        warm-replay the live version through it."""
        from repro_torch.session import Query

        session = self._session
        q = Query(session, rrec["spec"])
        prep = q.prepare(
            strategy=rrec.get("strategy"),
            params=rrec.get("params") or None,
            options=rrec.get("options"),
        )
        prep.serve(
            name=rrec["serve_name"], options=rrec.get("serve_options"),
        )
        srv = session.server
        route = srv.routes.get(rrec["serve_name"])
        live = self._live.get(model_name)
        if route is not None and rrec.get("ladder"):
            with srv._lock:
                route.ladder |= {tuple(e) for e in rrec["ladder"]}
        if live is not None:
            srv.warm_version(rrec["serve_name"], f"v{live}")

    # -- resolution (the one documented path) --------------------------------

    def _parse_ref(self, ref: str) -> tuple[str, Optional[str]]:
        name, sep, selector = str(ref).partition("@")
        return name, (selector if sep else None)

    def _get_version(self, name: str, version: int) -> ModelVersion:
        with self._lock:
            versions = self._versions.get(name)
            if versions is None:
                raise UnknownModelError(
                    f"unknown model '{name}' — registered models: "
                    f"{sorted(self._versions) or '(none)'}"
                )
            if not 1 <= version <= len(versions):
                raise UnknownModelVersionError(
                    f"model '{name}' has no version {version} — published: "
                    f"1..{len(versions)}"
                )
            return versions[version - 1]

    def resolve(self, ref: str) -> ModelVersion:
        """Resolve a model reference to a :class:`ModelVersion`.

        ``"name"`` / ``"name@live"`` → the live version; ``"name@2"`` →
        that exact version; ``"name@latest"`` → the newest published;
        ``"name@shadow"`` → the currently shadowed version (a
        :class:`~repro_torch.errors.RegistryStateError` when none is)."""
        name, selector = self._parse_ref(ref)
        with self._lock:
            if name not in self._versions:
                raise UnknownModelError(
                    f"unknown model '{name}' — registered models: "
                    f"{sorted(self._versions) or '(none)'}"
                )
            if selector is None or selector == "live":
                return self._get_version(name, self._live[name])
            if selector == "latest":
                return self._get_version(name, len(self._versions[name]))
            if selector == "shadow":
                shadowed = self._shadow.get(name)
                if shadowed is None:
                    raise RegistryStateError(
                        f"model '{name}' has no shadow version — set one "
                        f"with db.models.shadow('{name}', <version>)"
                    )
                return self._get_version(name, shadowed)
            if selector.isdigit():
                return self._get_version(name, int(selector))
            raise UnknownModelVersionError(
                f"malformed model reference {ref!r} — use 'name', 'name@N', "
                f"'name@latest', 'name@live', or 'name@shadow'"
            )

    # -- the mapping protocol the SQL frontend uses --------------------------

    def __contains__(self, ref) -> bool:
        name, _ = self._parse_ref(ref)
        with self._lock:
            return name in self._versions

    def __getitem__(self, ref):
        """The resolved version's *pipeline* (what ``build_prediction_query``
        embeds in the IR) — precise typed errors instead of KeyError."""
        return self.resolve(ref).pipeline

    def __iter__(self):
        with self._lock:
            return iter(sorted(self._versions))

    def __len__(self) -> int:
        with self._lock:
            return len(self._versions)

    # -- introspection -------------------------------------------------------

    def versions(self, name: str) -> list[ModelVersion]:
        with self._lock:
            if name not in self._versions:
                raise UnknownModelError(
                    f"unknown model '{name}' — registered models: "
                    f"{sorted(self._versions) or '(none)'}"
                )
            return list(self._versions[name])

    def snapshot(self) -> dict[str, Any]:
        """Registry state for ``db.cache_stats()['models']`` and the
        analysis layer: per-model live/shadow pointers, routes, and every
        version's state + recorded history."""
        with self._lock:
            return {
                name: {
                    "live": self._live.get(name),
                    "shadow": self._shadow.get(name),
                    "split": dict(self._split.get(name, {})),
                    "routes": [r.serve_name for r in self._routes.get(name, ())],
                    "rollbacks": [
                        dict(r) for r in self._rollbacks if r["model"] == name
                    ],
                    "versions": [
                        {
                            "version": mv.version,
                            "state": mv.state,
                            "history": list(mv.history),
                            "events": list(mv.events),
                            "fingerprint": mv.fingerprint,
                            "error": str(mv.error) if mv.error else None,
                        }
                        for mv in versions
                    ],
                }
                for name, versions in self._versions.items()
            }


class RollbackGuard:
    """Background watchdog for one model's live version.

    Periodically runs :meth:`ModelRegistry.check_rollback` and stops
    itself after triggering (rollback is one-shot until the next forward
    cutover records a fresh baseline) or on a contained evaluation error
    (``error`` — a watchdog must never raise into the serving path). The
    cadence uses ``Event.wait`` — no wall-clock reads — so ``stop()``
    interrupts a sleeping guard immediately.
    """

    def __init__(
        self,
        registry: ModelRegistry,
        name: str,
        policy: Optional[RollbackPolicy] = None,
        *,
        interval_s: float = 0.25,
    ):
        self._registry = registry
        self.name = name
        self.policy = policy
        self.interval_s = float(interval_s)
        self.checks = 0
        self.triggered: Optional[dict[str, Any]] = None
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"rollback-guard-{name}", daemon=True
        )

    def start(self) -> "RollbackGuard":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.checks += 1
            try:
                restored = self._registry.check_rollback(
                    self.name, self.policy
                )
            except BaseException as e:  # noqa: BLE001 — contained watchdog
                self.error = e
                return
            if restored is not None:
                self.triggered = {
                    "model": self.name, "restored": restored.version,
                }
                return
