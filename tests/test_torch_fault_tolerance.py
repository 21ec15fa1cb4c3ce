"""Fault tolerance of the port against the reference's, on the CPU.

The counterpart of ``tests/test_fault_tolerance.py``: seeded fault
injection at every instrumented site (``repro_torch.exec.faults``, copied
from the reference), retry/backoff, typed terminal failures, and the
circuit breaker's degradation onto the kernel-free fallback plan. Each
scenario runs on both packages with the same :class:`FaultPlan` (its
firing is a pure function of seed, site and call index, so both inject at
the same calls), the same tables, pipelines and batches. What must agree:
the faults injected per site, the answers (bitwise against the same
package's fault-free run; a decision tree's scores equal across packages),
the typed errors, and the counts ``retries``, ``retries_exhausted``,
``breaker_trips`` and the route's breaker state.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

import repro as jraven
from repro.analysis.registry_check import check_fault_tolerance as jcheck_fault_tolerance
from repro.data.datasets import make_hospital
from repro.exec import faults as rfaults
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.relational import engine as reng

import repro_torch as raven
from repro_torch.analysis.registry_check import check_fault_tolerance
from repro_torch.exec.faults import FaultPlan, FaultSpec, get_fault_plan, set_fault_plan
from repro_torch.kernels._build import KernelError
from repro_torch.kernels.ops import kernels_enabled
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.relational import engine as teng

SQL = "SELECT * FROM PREDICT(model='risk', data=patients) AS p"
AGG = ("SELECT COUNT(*), AVG(score) FROM PREDICT(model='risk', data=patients) AS p "
       "WHERE score >= 0.5")
BREAKER = ("degraded", "breaker_failures", "breaker_trips", "fallback_traces", "errors",
           "groups")


@pytest.fixture(scope="module")
def pipes(hospital_dt, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dt") / "dt.npz")
    ref_save_pipeline(hospital_dt, path)
    return {"ref": hospital_dt, "port": load_pipeline(path)}


@pytest.fixture(autouse=True)
def _no_plans():
    """No fault plan or artifact store leaks between tests."""
    yield
    for mod, eng in ((rfaults, reng), (raven.exec.faults, teng)):
        mod.set_fault_plan(None)
        eng.set_artifact_store(None)


def _pkg(side):
    return jraven if side == "ref" else raven


def _batch(n: int, seed: int) -> dict[str, np.ndarray]:
    return make_hospital(n, seed=seed).tables["patients"]


def _plan(side, specs, seed):
    return (rfaults.FaultPlan if side == "ref" else FaultPlan)(specs, seed=seed)


def _serve(side, hospital, pipes, *, faults=None, retry=None, breaker_threshold=None,
           cache_dir=None, transform="none", sql=SQL):
    pkg = _pkg(side)
    kw = {} if side == "ref" else {"device": "cpu"}
    db = pkg.connect(hospital.tables, stats="auto",
                     options=pkg.ConnectOptions(faults=faults, cache_dir=cache_dir), **kw)
    db.models.publish("risk", pipes[side])
    prep = db.sql(sql).prepare(transform=transform)
    prep.serve("q", options=pkg.ServeOptions(retry=retry, breaker_threshold=breaker_threshold))
    return db, prep


def _retry(side, **kw):
    return _pkg(side).RetryPolicy(**kw)


def _both(fn):
    return {side: fn(side) for side in ("ref", "port")}


def _scores(req) -> np.ndarray:
    return np.asarray(req.wait(timeout=60.0)["score"])


@pytest.fixture(scope="module")
def baseline(hospital, pipes):
    """No-fault ground truth for the host-boundary plan, per package."""
    def run(side):
        db, prep = _serve(side, hospital, pipes)
        try:
            req = prep.submit(_batch(128, seed=21))
            db.flush()
            return _scores(req)
        finally:
            db.close()

    got = _both(run)
    assert np.array_equal(got["port"], got["ref"])
    return got


# -- the plan itself ---------------------------------------------------------


def test_fault_plan_is_deterministic_and_the_references():
    a = FaultPlan({"stage": {"rate": 0.5, "times": None}}, seed=9)
    b = FaultPlan({"stage": {"rate": 0.5, "times": None}}, seed=9)
    ref = rfaults.FaultPlan({"stage": {"rate": 0.5, "times": None}}, seed=9)
    fired_a = [a.check("stage") is not None for _ in range(64)]
    assert fired_a == [b.check("stage") is not None for _ in range(64)]
    assert fired_a == [ref.check("stage") is not None for _ in range(64)]
    assert any(fired_a) and not all(fired_a)
    c = FaultPlan({"stage": {"rate": 0.5}}, seed=10)
    assert [c.check("stage") is not None for _ in range(64)] != fired_a


def test_fault_plan_parse_env_format():
    plan = FaultPlan.parse("seed=7; stage:times=2; latency:delay_ms=50,rate=0.5")
    assert plan.seed == 7
    assert plan.specs == (
        FaultSpec(site="stage", times=2),
        FaultSpec(site="latency", delay_ms=50.0, rate=0.5),
    )
    with pytest.raises(ValueError, match="unknown site"):
        FaultPlan.parse("bogus:times=1")
    with pytest.raises(ValueError, match="unknown site"):
        FaultPlan({"bogus": {}})


def test_session_installs_and_clears_plan(hospital):
    plan = FaultPlan({"stage": {"times": 1}}, seed=1)
    db = raven.connect(hospital.tables, stats=None, device="cpu",
                       options=raven.ConnectOptions(faults=plan))
    assert get_fault_plan() is plan
    db.close()
    assert get_fault_plan() is None


# -- the matrix: every site, no hang, no wrong result ------------------------


@pytest.mark.parametrize("site", ["dispatch", "stage", "udf", "worker"])
def test_transient_fault_recovers_bitwise(site, hospital, pipes, baseline):
    def run(side):
        plan = _plan(side, {site: {"times": 2}}, seed=11)
        db, prep = _serve(side, hospital, pipes, faults=plan,
                          retry=_retry(side, max_attempts=4, backoff_ms=0.25))
        try:
            req = prep.submit(_batch(128, seed=21))
            db.flush()
            out = _scores(req)
            stats = db.cache_stats()["server"]
            assert stats["faults_injected"] == plan.injected()
            return out, plan.injected(), stats["retries"]
        finally:
            db.close()

    got = _both(run)
    out, injected, retries = got["port"]
    assert injected.get(site, 0) >= 1, "matrix leg was vacuous"
    assert np.array_equal(out, baseline["port"])
    assert (injected, retries) == got["ref"][1:]


def test_transient_compile_fault_recovers_bitwise(hospital, pipes):
    # "compile" fires only where a stage makes a new specialization; plans
    # are cached process-wide by fingerprint, so the faulted session runs
    # first, over cleared plan caches
    sql = SQL + " WHERE p.age > 17.5"
    batch = _batch(128, seed=21)

    def run(side):
        (reng if side == "ref" else teng).clear_plan_cache()
        plan = _plan(side, {"compile": {"times": 2}}, seed=11)
        db, prep = _serve(side, hospital, pipes, faults=plan, sql=sql,
                          retry=_retry(side, max_attempts=4, backoff_ms=0.25))
        try:
            req = prep.submit(batch)
            db.flush()
            out = _scores(req)
        finally:
            db.close()
        clean, cprep = _serve(side, hospital, pipes, sql=sql)
        try:
            req = cprep.submit(batch)
            clean.flush()
            assert np.array_equal(out, _scores(req))
        finally:
            clean.close()
        return out, plan.injected()

    got = _both(run)
    assert got["port"][1].get("compile", 0) >= 1, "leg was vacuous"
    assert got["port"][1] == got["ref"][1]
    assert np.array_equal(got["port"][0], got["ref"][0])


def test_latency_fault_stalls_but_answers(hospital, pipes, baseline):
    def run(side):
        plan = _plan(side, {"latency": {"delay_ms": 30.0, "times": 2}}, seed=5)
        db, prep = _serve(side, hospital, pipes, faults=plan)
        try:
            req = prep.submit(_batch(128, seed=21))
            db.flush()
            assert np.array_equal(_scores(req), baseline[side])
            return plan.injected()
        finally:
            db.close()

    got = _both(run)
    assert got["port"] == got["ref"] and got["port"].get("latency", 0) >= 1


def test_store_read_fault_falls_back_to_live_specialization(tmp_path, hospital, pipes,
                                                            baseline):
    """Populate the store, then reconnect with every store read poisoned:
    loads degrade to live work — counted, never caller-visible."""
    def run(side):
        cache = str(tmp_path / side)
        db, prep = _serve(side, hospital, pipes, cache_dir=cache)
        req = prep.submit(_batch(128, seed=21))
        db.flush()
        req.wait(timeout=60.0)
        db.close()
        plan = _plan(side, {"store-read": {}}, seed=2)
        db, prep = _serve(side, hospital, pipes, faults=plan, cache_dir=cache)
        try:
            req = prep.submit(_batch(128, seed=21))
            db.flush()
            assert np.array_equal(_scores(req), baseline[side])
            store = db.cache_stats()["artifact_store"]
            return plan.injected(), store["corrupt"], store["fallbacks"]
        finally:
            db.close()

    got = _both(run)
    assert got["port"] == got["ref"]
    injected, corrupt, fallbacks = got["port"]
    assert injected.get("store-read", 0) >= 1 and corrupt >= 1 and fallbacks >= 1


# -- terminal failures: typed, delivered, contained --------------------------


def test_terminal_fault_delivers_typed_error_to_every_waiter(hospital, pipes, baseline):
    plan = FaultPlan({"dispatch": {"times": 1, "transient": False}}, seed=3)
    db, prep = _serve("port", hospital, pipes, faults=plan)
    try:
        # two requests on one bucket coalesce into the doomed group
        r1 = prep.submit(_batch(128, seed=21))
        r2 = prep.submit(_batch(128, seed=22))
        with pytest.raises(raven.FaultInjectedError):
            db.flush()
        for r in (r1, r2):
            with pytest.raises(raven.FaultInjectedError):
                r.wait(timeout=5.0)
        # the fault is spent: the route keeps serving, results exact
        r3 = prep.submit(_batch(128, seed=21))
        db.flush()
        assert np.array_equal(_scores(r3), baseline["port"])
        # the dispatch fault fires before a version is picked: no version's
        # error count moves, as in the reference
        assert db.server.route_snapshot("q")["versions"]["v1"]["errors"] == 0
    finally:
        db.close()


def test_retries_exhausted_raises_request_failed(hospital, pipes):
    def run(side):
        pkg = _pkg(side)
        plan = _plan(side, {"stage": {"times": 10}}, seed=4)
        db, prep = _serve(side, hospital, pipes, faults=plan,
                          retry=_retry(side, max_attempts=2, backoff_ms=0.25))
        try:
            req = prep.submit(_batch(64, seed=1))
            with pytest.raises(pkg.RequestFailedError):
                db.flush()
            with pytest.raises(pkg.RequestFailedError) as ei:
                req.wait(timeout=5.0)
            stats = db.cache_stats()["server"]
            return ei.value.attempts, stats["retries_exhausted"], plan.injected()
        finally:
            db.close()

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"][0] == 2 and got["port"][1] >= 1


def test_wait_timeout_is_typed(hospital, pipes):
    db, prep = _serve("port", hospital, pipes)
    try:
        req = prep.submit(_batch(64, seed=1))  # nobody flushes
        with pytest.raises(raven.RequestTimeoutError):
            req.wait(timeout=0.05)
        db.flush()  # leave the queue clean for close()
        req.wait(timeout=30.0)
    finally:
        db.close()


# -- circuit breaker: degrade to the kernel-free fallback --------------------


def _trip(side, hospital, pipes, sql, threshold, n_faults, batch):
    """Serve ``sql`` over a cleared plan cache and fail its first
    ``n_faults`` groups with terminal stage faults."""
    pkg = _pkg(side)
    (reng if side == "ref" else teng).clear_plan_cache()
    plan = _plan(side, {"stage": {"times": n_faults, "transient": False}}, seed=6)
    db, prep = _serve(side, hospital, pipes, faults=plan, breaker_threshold=threshold,
                      sql=sql)
    for _ in range(n_faults):
        r = prep.submit(batch)
        with pytest.raises(pkg.FaultInjectedError):
            db.flush()
        with pytest.raises(pkg.FaultInjectedError):
            r.wait(timeout=5.0)
    return db, prep


def test_breaker_trips_and_degrades_bitwise(hospital, pipes, baseline):
    def run(side):
        db, prep = _trip(side, hospital, pipes, SQL, 3, 3, _batch(128, seed=21))
        try:
            snap = db.server.route_snapshot("q")["versions"]["v1"]
            # degraded traffic serves the kernel-free fallback, bitwise equal
            r = prep.submit(_batch(128, seed=21))
            db.flush()
            assert np.array_equal(_scores(r), baseline[side])
            audit = check_fault_tolerance if side == "port" else jcheck_fault_tolerance
            assert audit(db) == []
            return ({k: snap[k] for k in BREAKER},
                    db.cache_stats()["server"]["breaker_trips"])
        finally:
            db.close()

    got = _both(run)
    assert got["port"] == got["ref"]
    snap, trips = got["port"]
    assert snap["degraded"] and snap["breaker_trips"] == 1 and trips == 1


@pytest.mark.parametrize("transform", ["dnn", "sql"])
def test_breaker_fallback_of_an_aggregate_plan(hospital, pipes, transform):
    """An aggregate plan's fallback is a plan of its own (the relational
    kernels off fork its fingerprint): it compiles, serves, and answers as
    the primary did (COUNT exactly, AVG within rtol 1e-5), as the
    reference's does."""
    batch = _batch(512, seed=23)

    def run(side):
        (reng if side == "ref" else teng).clear_plan_cache()
        clean, cprep = _serve(side, hospital, pipes, sql=AGG, transform=transform)
        want = cprep(batch)
        clean.close()
        db, prep = _trip(side, hospital, pipes, AGG, 2, 2, batch)
        try:
            r = prep.submit(batch)
            db.flush()
            out = r.wait(timeout=60.0)
            snap = db.server.route_snapshot("q")["versions"]["v1"]
            fb = db.server.queries["q"].fallback
            assert fb is not None and fb.fingerprint != db.server.queries["q"].compiled.fingerprint
            return out, want, {k: snap[k] for k in BREAKER}
        finally:
            db.close()

    got = _both(run)
    out, want, snap = got["port"]
    assert np.array_equal(out["count_rows"], want["count_rows"])
    np.testing.assert_allclose(out["mean_score"], want["mean_score"], rtol=1e-5)
    assert np.array_equal(out["count_rows"], got["ref"][0]["count_rows"])
    np.testing.assert_allclose(out["mean_score"], got["ref"][0]["mean_score"], rtol=1e-5)
    assert snap == got["ref"][2] and snap["degraded"] and snap["fallback_traces"] > 0


def test_breaker_success_resets_failure_count(hospital, pipes):
    def run(side):
        pkg = _pkg(side)
        plan = _plan(side, {"stage": {"times": 1, "transient": False}}, seed=8)
        db, prep = _serve(side, hospital, pipes, faults=plan, breaker_threshold=2)
        try:
            prep.submit(_batch(64, seed=1))
            with pytest.raises(pkg.FaultInjectedError):
                db.flush()
            r2 = prep.submit(_batch(64, seed=1))
            db.flush()
            r2.wait(timeout=60.0)
            snap = db.server.route_snapshot("q")["versions"]["v1"]
            return {k: snap[k] for k in BREAKER}
        finally:
            db.close()

    got = _both(run)
    assert got["port"] == got["ref"]
    assert got["port"]["breaker_failures"] == 0 and not got["port"]["degraded"]


def test_the_fallback_compiles_with_kernels_off_and_leaves_the_process_mode_alone(
        hospital, pipes, monkeypatch):
    """The breaker's fallback is ``compile_plan(kernels=False)``: the plan
    (and fingerprint) the ``RAVEN_KERNELS=off`` knob gives, compiled with
    the environment untouched, so a compile running beside it in another
    thread keeps the relational kernels on."""
    from repro_torch.serve import query_server as tqs

    monkeypatch.delenv("RAVEN_KERNELS", raising=False)
    seen = []
    real = tqs.compile_plan

    def spy(plan, *args, **kwargs):
        seen.append((kwargs.get("kernels"), os.environ.get("RAVEN_KERNELS"),
                     kernels_enabled()))
        return real(plan, *args, **kwargs)

    monkeypatch.setattr(tqs, "compile_plan", spy)
    db, _ = _trip("port", hospital, pipes, AGG, 2, 2, _batch(512, seed=23))
    try:
        reg = db.server.queries["q"]
        assert reg.fallback is not None
        assert seen[-1] == (False, None, True), seen
        assert "RAVEN_KERNELS" not in os.environ and kernels_enabled()
        assert teng.plan_fingerprint(reg.plan) == reg.compiled.fingerprint
        assert teng.plan_fingerprint(reg.plan, kernels=False) == reg.fallback.fingerprint
        monkeypatch.setenv("RAVEN_KERNELS", "off")
        assert teng.plan_fingerprint(reg.plan) == reg.fallback.fingerprint
    finally:
        db.close()


def _failing_launch(*args, **kwargs):
    raise KernelError("segment_agg: CUDA error 1 at launch: invalid argument")


def test_a_kernel_error_fails_its_requests_and_never_trips_the_breaker(
        hospital, pipes, monkeypatch):
    """A kernel that fails to build or launch raises ``KernelError``: its
    group's requests fail with it and it counts as the version's error, but
    never toward the breaker. With a threshold of 1, two such failures
    leave the route on its primary plan (no fallback compiled), which
    serves through the kernel again once it launches."""
    from repro_torch.tensor import compile as tcompile

    batch = _batch(512, seed=23)
    teng.clear_plan_cache()
    db, prep = _serve("port", hospital, pipes, breaker_threshold=1, sql=AGG,
                      transform="dnn")
    try:
        want = prep(batch)
        with monkeypatch.context() as m:
            m.setattr(tcompile, "emit_aggregate_kernel", _failing_launch)
            for _ in range(2):
                r = prep.submit(batch)
                with pytest.raises(KernelError):
                    db.flush()
                with pytest.raises(raven.RavenError) as ei:
                    r.wait(timeout=5.0)
                assert isinstance(ei.value.__cause__, KernelError)
        snap = db.server.route_snapshot("q")["versions"]["v1"]
        assert {k: snap[k] for k in BREAKER} == {
            "degraded": False, "breaker_failures": 0, "breaker_trips": 0,
            "fallback_traces": 0, "errors": 2, "groups": 2}
        assert db.server.queries["q"].fallback is None
        assert db.cache_stats()["server"]["breaker_trips"] == 0
        r = prep.submit(batch)
        db.flush()
        out = r.wait(timeout=60.0)
        assert np.array_equal(out["count_rows"], want["count_rows"])
        np.testing.assert_allclose(out["mean_score"], want["mean_score"], rtol=1e-5)
    finally:
        db.close()


# -- env-var plan ------------------------------------------------------------


def test_env_fault_plan(hospital, pipes, monkeypatch, baseline):
    monkeypatch.setenv("RAVEN_FAULTS", "seed=12;stage:times=1")
    assert get_fault_plan() is not None
    db, prep = _serve("port", hospital, pipes,
                      retry=raven.RetryPolicy(max_attempts=3, backoff_ms=0.25))
    try:
        req = prep.submit(_batch(128, seed=21))
        db.flush()
        assert np.array_equal(_scores(req), baseline["port"])
        assert db.cache_stats()["server"]["retries"] >= 1
    finally:
        db.close()
        monkeypatch.delenv("RAVEN_FAULTS")
        set_fault_plan(None)
