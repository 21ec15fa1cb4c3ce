"""The port's model lifecycle against the reference's, on the CPU.

The counterpart of ``tests/test_registry.py``'s lifecycle tests: publish →
warm → shadow/split → cutover → rollback → retire through
``db.models`` (:mod:`repro_torch.serve.registry`), and the query server's
route methods under it (``stage_version``, ``warm_version``,
``set_shadow``, ``set_split``, ``cutover``, ``retire_version``,
``route_snapshot``). Each scenario runs on both packages over the same
tables, pipelines (trained by the reference, carried over through its save
format) and batches. What must agree: route snapshots (every field the
reference reports but the latency percentile, with ``traces`` the port's
specializations), registry snapshots, the served-by version of every
request, the counts ``recompiles``, ``cutovers``, ``warm_replayed_buckets``
and ``shadow_mirrored_groups``, and the answers: a decision tree's scores
exactly, logistic regression's within ``rtol=1e-5``. Where the reference's
tests audit the registry with ``check_registry``, both audits agree.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import repro as jraven
from repro.analysis.registry_check import check_registry as jcheck_registry
from repro.data.datasets import make_hospital
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.relational import engine as reng

import repro_torch as raven
from repro_torch.analysis.registry_check import check_registry
from repro_torch.errors import (
    RegistryStateError,
    StaleQueryError,
    UnknownModelError,
    UnknownModelVersionError,
)
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.relational import engine as teng

SQL = "SELECT * FROM PREDICT(model='risk', data=patients) AS p"
# route-snapshot fields the two packages must agree on (the reference's,
# but p99_ms: a wall-clock percentile)
VERSION_FIELDS = ("warmed", "traces", "degraded", "breaker_failures", "breaker_trips",
                  "fallback_traces", "groups", "requests", "rows", "errors",
                  "shadow_groups", "shadow_rows", "shadow_diff_rows", "shadow_errors")
SERVER_COUNTS = ("cutovers", "warm_replayed_buckets", "shadow_mirrored_groups",
                 "requests_served", "flushes", "bucket_hits", "bucket_misses")


@pytest.fixture(scope="module")
def pipes(hospital_dt, hospital_lr, tmp_path_factory):
    out = {}
    for kind, ref_pipe in (("dt", hospital_dt), ("lr", hospital_lr)):
        path = str(tmp_path_factory.mktemp(kind) / f"{kind}.npz")
        ref_save_pipeline(ref_pipe, path)
        out[kind] = {"ref": ref_pipe, "port": load_pipeline(path)}
    return out


def _batch(n: int, seed: int) -> dict[str, np.ndarray]:
    return make_hospital(n, seed=seed).tables["patients"]


def _db(side, hospital, pipes):
    """A session over the hospital tables with ``risk`` v1 (the decision
    tree) live, over a cleared plan cache."""
    (reng if side == "ref" else teng).clear_plan_cache()
    if side == "ref":
        db = jraven.connect(hospital.tables, stats="auto")
    else:
        db = raven.connect(hospital.tables, stats="auto", device="cpu")
    db.models.publish("risk", pipes["dt"][side])
    return db


def _served(db, params=None):
    prep = db.sql(SQL).prepare(transform="sql", params=params)
    prep.serve("q")
    return prep


def _roundtrip(db, prep, batch):
    req = prep.submit(batch)
    db.flush()
    return req


def _both(fn):
    """Run ``fn(side)`` on the reference, then the port."""
    return {side: fn(side) for side in ("ref", "port")}


def _route(db, name="q") -> dict:
    snap = db.server.route_snapshot(name)
    out = {k: snap[k] for k in ("live", "shadow", "split", "cutovers",
                                "last_cutover_deficit", "ladder")}
    out["versions"] = {
        label: {k: v[k] for k in VERSION_FIELDS}
        for label, v in snap["versions"].items()
    }
    return out


def _server_counts(db) -> dict:
    st = db.cache_stats()["server"]
    return {k: st[k] for k in SERVER_COUNTS} | {"recompiles": st["recompiles"]}


def _assert_results(got: dict, want: dict, rtol: float = 0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if w.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6)
        else:
            assert np.array_equal(g, w), k


# -- resolution --------------------------------------------------------------


def test_resolve_paths_and_shadow_selector(hospital, pipes):
    def run(side):
        db = _db(side, hospital, pipes)
        db.models.publish("risk", pipes["lr"][side], warm="off")
        out = [db.models.resolve(r).version
               for r in ("risk", "risk@live", "risk@latest", "risk@2")]
        errors = []
        for ref in ("nope", "risk@9", "risk@banana", "risk@shadow"):
            try:
                db.models.resolve(ref)
            except Exception as e:  # noqa: BLE001 — the typed error is compared
                errors.append(type(e).__name__)
        _served(db)
        db.models.shadow("risk", 2)
        out.append(db.models.resolve("risk@shadow").version)
        return out, errors

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"] == ([1, 1, 2, 2, 2], ["UnknownModelError", "UnknownModelVersionError",
                                              "UnknownModelVersionError",
                                              "RegistryStateError"])


def test_first_publish_goes_live(hospital, pipes):
    db = _db("port", hospital, pipes)
    (v1,) = db.models.versions("risk")
    assert v1.state == "live" and v1.ref == "risk@1" and v1.label == "v1"
    assert db.models.resolve("risk") is v1
    assert "risk" in db.models and list(db.models) == ["risk"] and len(db.models) == 1
    with pytest.raises(UnknownModelError):
        db.models.versions("nope")


# -- lifecycle ---------------------------------------------------------------


def test_publish_warm_sync_stages_routes(hospital, pipes):
    def run(side):
        db = _db(side, hospital, pipes)
        prep = _served(db)
        _roundtrip(db, prep, _batch(96, seed=2)).wait(5)
        v2 = db.models.publish("risk", pipes["lr"][side], warm="sync")
        return v2.state, list(v2.history), _route(db), _server_counts(db)

    got = _both(run)
    assert got["port"] == got["ref"]
    state, history, route, _ = got["port"]
    assert state == "ready" and history == ["published", "warming", "ready"]
    assert set(route["versions"]) == {"v1", "v2"} and route["versions"]["v2"]["warmed"]


def test_publish_background_wait_ready(hospital, pipes):
    db = _db("port", hospital, pipes)
    prep = _served(db)
    _roundtrip(db, prep, _batch(96, seed=2)).wait(5)
    v2 = db.models.publish("risk", pipes["lr"]["port"])  # warm="background"
    assert v2.wait_ready(timeout=120.0) is v2
    assert v2.state == "ready"
    assert db.server.route_snapshot("q")["versions"]["v2"]["warmed"]


def _wait_shadow(db, groups: int) -> dict:
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:  # mirrors run on the boundary pool
        vs = db.server.route_snapshot("q")["versions"]["v2"]
        if vs["shadow_groups"] >= groups:
            break
        time.sleep(0.01)
    return vs


def test_shadow_never_leaks(hospital, pipes):
    def run(side):
        db = _db(side, hospital, pipes)
        prep = _served(db)
        batch = _batch(200, seed=4)
        oracle = _roundtrip(db, prep, batch).wait(5)  # v1-only answer
        db.models.publish("risk", pipes["lr"][side], warm="sync")
        db.models.shadow("risk", 2)
        outs = []
        for _ in range(3):
            req = _roundtrip(db, prep, batch)
            outs.append((req.served_by, req.wait(5)))
        vs = _wait_shadow(db, 3)
        shadowed = db.models.resolve("risk@shadow").version
        route = _route(db)
        db.models.shadow("risk", None)
        return (oracle, outs, vs["shadow_max_abs_diff"], shadowed, route,
                db.server.route_snapshot("q")["shadow"], _server_counts(db))

    got = _both(run)
    oracle, outs, max_diff, shadowed, route, cleared, counts = got["port"]
    for served_by, out in outs:
        assert served_by == "v1"
        _assert_results(out, oracle)  # the shadow's answers never leak
    _assert_results(oracle, got["ref"][0])
    assert route == got["ref"][4] and counts == got["ref"][6]
    vs = route["versions"]["v2"]
    assert vs["shadow_groups"] == 3 and vs["shadow_errors"] == 0
    assert vs["shadow_rows"] == 600 and vs["groups"] == 0
    np.testing.assert_allclose(max_diff, got["ref"][2], rtol=1e-5)
    assert shadowed == 2 and cleared is None


def test_split_deterministic_counts(hospital, pipes):
    def run(side):
        db = _db(side, hospital, pipes)
        prep = _served(db)
        batch = _batch(64, seed=6)
        _roundtrip(db, prep, batch).wait(5)
        db.models.publish("risk", pipes["lr"][side], warm="sync")
        db.models.split("risk", {2: 0.25})
        served = []
        scores = {}
        for _ in range(16):
            req = _roundtrip(db, prep, batch)
            scores[req.served_by] = req.wait(5)["score"]
            served.append(req.served_by)
        route = _route(db)
        db.models.split("risk", {})  # clears
        req = _roundtrip(db, prep, batch)
        req.wait(5)
        return served, route, req.served_by, scores

    got = _both(run)
    served, route, after, scores = got["port"]
    assert served == got["ref"][0]
    assert served.count("v2") == 4 and served.count("v1") == 12  # exactly
    assert route == got["ref"][1] and route["versions"]["v2"]["groups"] == 4
    assert after == "v1"
    assert np.array_equal(scores["v1"], got["ref"][3]["v1"])
    np.testing.assert_allclose(scores["v2"], got["ref"][3]["v2"], rtol=1e-5)


def test_split_validation(hospital, pipes):
    db = _db("port", hospital, pipes)
    _served(db)
    db.models.publish("risk", pipes["lr"]["port"], warm="sync")
    with pytest.raises(RegistryStateError):
        db.server.set_split("q", {"v2": 1.5})
    with pytest.raises(RegistryStateError):
        db.server.set_split("q", {"v1": 0.5})  # live can't be a split target
    with pytest.raises(RegistryStateError, match="remainder"):
        db.server.set_split("q", {"v2": 0.99, "v1": 0.0})
    with pytest.raises(UnknownModelVersionError):
        db.server.set_split("q", {"v9": 0.5})


def test_cutover_swaps_and_handles_survive(hospital, pipes):
    def run(side):
        db = _db(side, hospital, pipes)
        prep = _served(db)
        batch = _batch(128, seed=8)
        _roundtrip(db, prep, batch).wait(5)
        db.models.publish("risk", pipes["lr"][side], warm="sync")
        v2 = db.models.cutover("risk", 2)
        states = (v2.state, db.models.resolve("risk").version,
                  db.models.versions("risk")[0].state)
        # the outstanding handle keeps working across the cutover
        req = _roundtrip(db, prep, batch)
        out = req.wait(5)
        with pytest.raises(Exception, match="already live") as ei:
            db.models.cutover("risk", 2)
        assert type(ei.value).__name__ == "RegistryStateError"
        return states, req.served_by, out, db.models.snapshot(), _route(db)

    got = _both(run)
    assert got["port"][0] == got["ref"][0] == ("live", 2, "ready")
    assert got["port"][1] == got["ref"][1] == "v2"
    _assert_results(got["port"][2], got["ref"][2], rtol=1e-5)
    port_models, ref_models = got["port"][3], got["ref"][3]
    for snap in (port_models, ref_models):
        for v in snap["risk"]["versions"]:
            v.pop("fingerprint")  # each package hashes its own tokens
    assert port_models == ref_models
    assert got["port"][4] == got["ref"][4]


def test_cutover_zero_retrace(hospital, pipes):
    def run(side):
        db = _db(side, hospital, pipes)
        prep = _served(db)
        batch = _batch(128, seed=8)
        _roundtrip(db, prep, batch).wait(5)
        db.models.publish("risk", pipes["lr"][side], warm="sync")
        before = db.server.recompiles()
        db.models.cutover("risk", 2)
        _roundtrip(db, prep, batch).wait(5)
        return before, db.server.recompiles(), _route(db)["last_cutover_deficit"]

    got = _both(run)
    assert got["port"] == got["ref"]
    before, after, deficit = got["port"]
    assert after == before and deficit == 0  # a warm swap specializes nothing


def test_cutover_require_warm_refuses_cold(hospital, pipes):
    def run(side):
        db = _db(side, hospital, pipes)
        prep = _served(db)
        _roundtrip(db, prep, _batch(128, seed=8)).wait(5)
        v2 = db.models.publish("risk", pipes["lr"][side], warm="off")
        db.models._ensure_staged(v2)
        db.server.routes["q"].versions["v2"].warmed_ladder.clear()  # a cold version
        with pytest.raises(Exception, match="not warm") as ei:
            db.server.cutover("q", "v2", require_warm=True)
        db.server.cutover("q", "v2", require_warm=False)  # forced: recorded
        return type(ei.value).__name__, _route(db)["last_cutover_deficit"]

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][0] == "RegistryStateError" and got["port"][1] > 0


def test_retire_guards(hospital, pipes):
    def run(side):
        db = _db(side, hospital, pipes)
        _served(db)
        db.models.publish("risk", pipes["lr"][side], warm="sync")
        with pytest.raises(Exception, match="live"):
            db.models.retire("risk", 1)
        db.models.shadow("risk", 2)
        with pytest.raises(Exception, match="shadow"):
            db.models.retire("risk", 2)
        db.models.shadow("risk", None)
        db.models.cutover("risk", 2)
        db.models.retire("risk", 1)
        return ([v.state for v in db.models.versions("risk")],
                sorted(db.server.routes["q"].versions))

    got = _both(run)
    assert got["port"] == got["ref"] == (["retired", "live"], ["v2"])


def test_retire_version_refuses_split_target(hospital, pipes):
    db = _db("port", hospital, pipes)
    _served(db)
    db.models.publish("risk", pipes["lr"]["port"], warm="sync")
    db.models.split("risk", {2: 0.5})
    with pytest.raises(RegistryStateError, match="shadow/split"):
        db.server.retire_version("q", "v2")
    db.models.split("risk", {})
    db.server.retire_version("q", "v2")
    assert sorted(db.server.routes["q"].versions) == ["v1"]


def test_reregister_still_stales_handles(hospital, pipes):
    db = _db("port", hospital, pipes)
    prep = _served(db)
    token = prep._serve_token
    prep2 = db.sql(SQL).prepare(transform="sql")
    prep2.serve("q")  # same name, fresh registration: new token
    assert prep2._serve_token != token
    with pytest.raises(StaleQueryError):
        db.server.submit("q", _batch(32, seed=1), expect_token=token)


def test_stage_rejects_schema_outside_fact_table(hospital, pipes):
    """A staged version may read columns the live plan pruned, but never
    columns outside the registered fact schema."""
    db = _db("port", hospital, pipes)
    _served(db)
    live = db.server.routes["q"].versions["v1"]
    assert set(live.scan_columns) <= set(live.fact_dtypes)
    assert set(live.fact_dtypes) == set(db.tables["patients"])


def test_cache_stats_exposes_models_and_routes(hospital, pipes):
    db = _db("port", hospital, pipes)
    snap = db.cache_stats()
    assert snap["models"]["risk"]["live"] == 1
    assert [v["state"] for v in snap["models"]["risk"]["versions"]] == ["live"]
    prep = _served(db)
    _roundtrip(db, prep, _batch(64, seed=2)).wait(5)
    routes = db.cache_stats()["server"]["routes"]
    assert routes["q"]["live"] == "v1" and routes["q"]["ladder"] == [(64, 0)]
    # the CPU captures nothing: no graph held or dropped, no warm deficit
    v1 = routes["q"]["versions"]["v1"]
    assert (v1["graphs"], v1["graph_evictions"], v1["warm_deficit"]) == (0, 0, 0)
    assert "rolled back" not in prep.explain() and "live=v1" in prep.explain()


# -- the route methods under the registry ------------------------------------


def test_server_route_methods_as_the_reference(hospital, pipes):
    """The server's six route methods driven directly: stage, warm (the
    route's ladder), shadow, split, cutover, retire."""
    def run(side):
        db = _db(side, hospital, pipes)
        prep = _served(db)
        for n, seed in ((64, 1), (200, 2), (700, 3)):
            _roundtrip(db, prep, _batch(n, seed)).wait(5)
        q = db.sql("SELECT * FROM PREDICT(model='risk@1', data=patients) AS p")
        srv = db.server
        db.models.publish("risk", pipes["lr"][side], warm="off")
        q2 = db.sql("SELECT * FROM PREDICT(model='risk@2', data=patients) AS p")
        plan = q2.prepare(transform="sql")
        tables = db.tables if side == "ref" else db.database
        srv.stage_version("q", q2.ir, tables, version_label="v2",
                          optimized=(plan.plan, plan.report))
        replayed = srv.warm_version("q", "v2")
        again = srv.warm_version("q", "v2")
        srv.set_shadow("q", "v2")
        srv.set_split("q", {"v2": 0.5})
        served = []
        for _ in range(4):
            req = _roundtrip(db, prep, _batch(64, seed=9))
            req.wait(5)
            served.append(req.served_by)
        _wait_shadow(db, 4)  # every mirror landed
        srv.set_shadow("q", None)
        srv.set_split("q", {})
        srv.cutover("q", "v2")
        srv.retire_version("q", "v1")
        assert q.ir is not None
        return replayed, again, served, _route(db), _server_counts(db)

    got = _both(run)
    assert got["port"] == got["ref"]
    replayed, again, served, route, _ = got["port"]
    assert (replayed, again) == (3, 0)
    assert served == ["v1", "v2", "v1", "v2"]
    assert route["live"] == "v2" and sorted(route["versions"]) == ["v2"]


# -- rollback ----------------------------------------------------------------


def test_check_rollback_policy_and_guard(hospital, pipes):
    """``check_rollback`` rolls the live version back on a breached
    policy (here every mirrored row differs: a shadow diff rate over 0),
    and a guard does it from its own thread, once."""
    def run(side):
        pkg = jraven if side == "ref" else raven
        db = _db(side, hospital, pipes)
        prep = _served(db)
        batch = _batch(64, seed=3)
        _roundtrip(db, prep, batch).wait(5)
        db.models.publish("risk", pipes["lr"][side], warm="sync")
        db.models.cutover("risk", 2)
        db.models.publish("risk", pipes["dt"][side], warm="sync")
        db.models.shadow("risk", 3)
        policy = pkg.RollbackPolicy(max_error_rate=0.0, min_requests=4)
        assert db.models.check_rollback("risk", policy) is None  # too few requests
        for _ in range(4):
            _roundtrip(db, prep, batch).wait(5)
        assert db.models.check_rollback("risk", policy) is None  # no errors
        g = db.models.guard("risk", pkg.RollbackPolicy(max_p99_ratio=1e-9, min_requests=1),
                            interval_s=0.01)
        deadline = time.monotonic() + 30
        while g.running and time.monotonic() < deadline:
            time.sleep(0.01)
        db.models.close()
        snap = db.models.snapshot()["risk"]
        return (g.triggered, g.error, snap["live"],
                [(r["from"], r["to"]) for r in snap["rollbacks"]])

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"model": "risk", "restored": 1}
    assert got["port"][2:] == (1, [(2, 1)])


def test_rollback_without_cutover_raises(hospital, pipes):
    db = _db("port", hospital, pipes)
    with pytest.raises(RegistryStateError, match="previous live version"):
        db.models.rollback("risk")


# -- the atomicity stress ----------------------------------------------------


def test_concurrent_cutover_stress(hospital, pipes):
    """3 submitting threads race a cutover: zero dropped requests, zero
    new specializations, results stable per version and equal to the
    reference's answers of that version."""
    db = _db("port", hospital, pipes)
    prep = _served(db)
    batch = _batch(256, seed=9)
    _roundtrip(db, prep, batch).wait(5)  # the v1 bucket
    v2 = db.models.publish("risk", pipes["lr"]["port"], warm="sync")
    assert v2.state == "ready"
    before = db.server.recompiles()
    results: list[tuple[str, dict]] = []
    errors: list[BaseException] = []
    lock = threading.Lock()
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            try:
                req = prep.submit(batch)
                db.flush()
                out = req.wait(30)
            except BaseException as e:  # noqa: BLE001 — recorded, asserted
                with lock:
                    errors.append(e)
                return
            with lock:
                results.append((req.served_by, out))

    def served(label):
        with lock:
            return sum(1 for s, _ in results if s == label)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while served("v1") < 6 and time.monotonic() < deadline:
        time.sleep(0.001)
    db.models.cutover("risk", 2)
    while served("v2") < 6 and time.monotonic() < deadline:
        time.sleep(0.001)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    db.flush()  # nothing may be left enqueued
    assert errors == []
    assert db.server.recompiles() == before
    by_version: dict[str, dict] = {}
    for label, out in results:
        _assert_results(out, by_version.setdefault(label, out))
    assert set(by_version) == {"v1", "v2"}
    snap = db.server.route_snapshot("q")
    assert snap["cutovers"] == 1 and snap["last_cutover_deficit"] == 0

    ref = _db("ref", hospital, pipes)
    ref_prep = _served(ref)
    want_v1 = _roundtrip(ref, ref_prep, batch).wait(5)
    ref.models.publish("risk", pipes["lr"]["ref"], warm="sync")
    ref.models.cutover("risk", 2)
    want_v2 = _roundtrip(ref, ref_prep, batch).wait(5)
    _assert_results(by_version["v1"], want_v1)
    _assert_results(by_version["v2"], want_v2, rtol=1e-5)


def test_registry_check_clean_and_dirty(hospital, pipes):
    """The reference's audit test on both packages: clean after a warmed
    cutover; a corrupted history is a ``registry-state`` violation in
    both."""
    def run(side):
        db = _db(side, hospital, pipes)
        audit = check_registry if side == "port" else jcheck_registry
        try:
            prep = _served(db)
            _roundtrip(db, prep, _batch(64, seed=2)).wait(5)
            db.models.publish("risk", pipes["lr"][side], warm="sync")
            db.models.cutover("risk", 2)
            clean = audit(db)
            # corrupt the recorded history: the independent audit notices
            db.models.versions("risk")[0].history.append("published")
            return clean, sorted((v.rule, v.where) for v in audit(db))
        finally:
            db.close()

    got = _both(run)
    assert got["port"] == got["ref"]
    clean, dirty = got["port"]
    assert clean == [] and any(rule == "registry-state" for rule, _ in dirty)
