"""The port's scheduler and pipelined executor against the reference's, on
the CPU.

``repro_torch.exec.scheduler`` is the reference's scheduler with its
imports rewritten: the unit cases (coalesce cap, earliest-deadline-first
order, backpressure, no deadlock without a pump, drain waiting for groups
in flight) run on both with the same outcome. Through the port's front door:
a bounded queue rejects or blocks submits at ``max_pending``; threaded
submitters against two queries (one pure, one with a host boundary) never
lose or misroute a result; a small latency-targeted query keeps flowing
while a bulk group is in flight; pipelined execution specializes exactly as
the serial path does (no new trace on a warm bucket, the reference's
counts) and returns the same results; forced donation drops the entry
stage's consumed inputs and changes no result.
"""
from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

import repro as jraven
from repro.data.datasets import make_hospital
from repro.errors import ServerOverloadedError as RefOverloaded
from repro.exec.scheduler import Scheduler as RefScheduler
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.relational import engine as reng

import repro_torch as raven
from repro_torch.errors import ServerOverloadedError
from repro_torch.exec.scheduler import Scheduler
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.relational import engine as teng
from repro_torch.serve import PredictionQueryServer

SQL = "SELECT * FROM PREDICT(model='m', data=patients) AS p WHERE score >= :t"
PACKAGES = {"reference": (RefScheduler, RefOverloaded), "port": (Scheduler, ServerOverloadedError)}


def _batch(n, seed):
    return make_hospital(n, seed=seed).tables["patients"]


# ---------------------------------------------------------------------------
# Scheduler unit behaviour, on both packages
# ---------------------------------------------------------------------------


class _Req:
    def __init__(self, rid, t_submit):
        self.rid = rid
        self.t_submit = t_submit


def _pop(sch, q):
    with sch._cv:  # _pop_group's contract: caller holds the scheduler lock
        group, _attempt = sch._pop_group(q)
        return group


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_pop_group_respects_coalesce_cap(pkg):
    sch = PACKAGES[pkg][0](lambda name, group: None, default_coalesce=100)
    now = time.perf_counter()
    for i, n in enumerate((40, 40, 40, 200, 10)):
        sch.enqueue("q", _Req(i, now), n)
    q = sch._queues["q"]
    assert [[r.rid for r in _pop(sch, q)] for _ in range(4)] == [[0, 1], [2], [3], [4]]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_edf_picks_tightest_deadline_and_rotates_overdue(pkg):
    sch = PACKAGES[pkg][0](lambda name, group: None)
    sch.configure("bulk", max_latency_ms=50.0)
    sch.configure("fast", max_latency_ms=5.0)
    t0 = time.perf_counter()
    sch.enqueue("bulk", _Req(0, t0), 1)
    sch.enqueue("fast", _Req(1, t0 + 0.010), 1)
    assert sch._earliest(now=t0 + 0.012).name == "fast"
    far = t0 + 10.0
    first = sch._earliest(now=far)
    _pop(sch, first)
    sch.enqueue(first.name, _Req(2, t0), 1)
    assert sch._earliest(now=far).name != first.name


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_backpressure_blocks_then_raises_on_timeout(pkg):
    cls, overloaded = PACKAGES[pkg]
    sch = cls(lambda name, group: None)
    sch.configure("q", max_pending=2)
    now = time.perf_counter()
    sch.enqueue("q", _Req(0, now), 1)
    sch.enqueue("q", _Req(1, now), 1)
    with pytest.raises(overloaded, match="max_pending=2"):
        sch.enqueue("q", _Req(2, now), 1, block=False)
    t0 = time.perf_counter()
    with pytest.raises(overloaded):
        sch.enqueue("q", _Req(2, now), 1, timeout=0.15)
    assert time.perf_counter() - t0 >= 0.1
    assert sch.overloads == 2 and sch.backpressure_waits == 1
    unblocked = threading.Event()

    def submitter():
        sch.enqueue("q", _Req(3, time.perf_counter()), 1, timeout=5.0)
        unblocked.set()

    t = threading.Thread(target=submitter)
    t.start()
    time.sleep(0.05)
    _pop(sch, sch._queues["q"])
    t.join(5.0)
    assert not t.is_alive() and unblocked.is_set()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_blocking_submit_without_pump_fails_fast_instead_of_deadlocking(pkg):
    cls, overloaded = PACKAGES[pkg]
    sch = cls(lambda name, group: None)
    sch.configure("q", max_pending=1)
    sch.enqueue("q", _Req(0, time.perf_counter()), 1)
    with pytest.raises(overloaded, match="no pump thread"):
        sch.enqueue("q", _Req(1, time.perf_counter()), 1)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_drain_waits_for_groups_the_pump_already_took(pkg):
    done = threading.Event()

    def slow_dispatch(name, group):
        fut: Future = Future()

        def finish():
            time.sleep(0.2)
            for r in group:
                r.served = True
            done.set()
            fut.set_result(group)

        threading.Thread(target=finish, daemon=True).start()
        return fut

    sch = PACKAGES[pkg][0](slow_dispatch, default_latency_ms=1.0)
    sch.start()
    try:
        req = _Req(0, time.perf_counter())
        req.served = False
        sch.enqueue("q", req, 1)
        deadline = time.time() + 5.0
        while sch.depths().get("q") and time.time() < deadline:
            time.sleep(0.005)
        sch.drain()
        assert req.served and done.is_set()
    finally:
        sch.stop()


# ---------------------------------------------------------------------------
# Through the port's front door
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes(hospital, hospital_dt, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dt") / "dt.npz")
    ref_save_pipeline(hospital_dt, path)
    return hospital_dt, load_pipeline(path)


@pytest.fixture()
def db(hospital, pipes):
    sess = raven.connect(hospital.tables, stats="auto", device="cpu")
    sess.register_model("m", pipes[1])
    yield sess
    sess.close()


def test_submit_overload_raises_and_recovers(db):
    prep = db.sql(SQL).prepare(transform="sql", params={"t": 0.6}).serve(
        name="bounded", max_pending=2,
    )
    r1 = prep.submit(_batch(8, seed=1))
    r2 = prep.submit(_batch(8, seed=2))
    with pytest.raises(ServerOverloadedError, match="bounded"):
        prep.submit(_batch(8, seed=3), block=False)
    with pytest.raises(ServerOverloadedError):
        prep.submit(_batch(8, seed=3), timeout=0.05)
    db.flush()
    assert r1.done and r2.done
    r3 = prep.submit(_batch(8, seed=3), block=False)
    db.flush()
    assert r3.done
    stats = db.cache_stats()["server"]
    assert stats["overloads"] >= 2 and stats["max_queue_depth"] >= 2


def test_blocked_submit_proceeds_when_pump_frees_space(db):
    prep = db.sql(SQL).prepare(transform="sql", params={"t": 0.6}).serve(
        name="bounded2", max_pending=1, max_latency_ms=5,
    )
    reqs = [prep.submit(_batch(16, seed=i), timeout=30.0) for i in range(6)]
    outs = [r.wait(timeout=30.0) for r in reqs]
    assert all(o is not None for o in outs)


def test_threaded_submitters_two_queries_no_lost_or_misrouted(db):
    """One pure query and one with a host boundary served from one
    scheduler; 6 submitter threads (more than a small machine's cores, the
    interpreter switching every 10 µs) interleave batches whose ``age``
    column encodes (thread, sequence), so a lost or misrouted row shows."""
    pure = db.sql(SQL).prepare(transform="sql", params={"t": -1e9}).serve(
        name="pure_q", max_latency_ms=3,
    )
    udf = db.sql(SQL).prepare(transform="none", params={"t": -1e9}).serve(
        name="udf_q", max_latency_ms=3,
    )
    n_threads, n_per = 6, 5
    results: dict[tuple, tuple] = {}
    errors: list[BaseException] = []
    lock = threading.Lock()

    def submitter(tid):
        try:
            for i in range(n_per):
                n = 16 + 8 * ((tid + i) % 3)
                b = dict(_batch(n, seed=100 + tid * 31 + i))
                tag = float(1000 * tid + i)
                b["age"] = np.full(n, tag)
                prep = pure if (tid + i) % 2 == 0 else udf
                out = prep.submit(b).wait(timeout=60.0)
                with lock:
                    results[(tid, i)] = (tag, n, out)
        except BaseException as e:  # pragma: no cover - the assertion target
            with lock:
                errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(results) == n_threads * n_per
    for (tid, i), (tag, n, out) in results.items():
        assert len(out["age"]) == n, (tid, i)
        np.testing.assert_array_equal(np.unique(out["age"]), [tag])


def test_small_query_keeps_flowing_while_a_bulk_group_is_in_flight(db):
    """A large host-boundary group and a small pure query on one server:
    the pipelined dispatch overlaps them, and every small request is served
    while the bulk work is still queued or in flight."""
    bulk = db.sql(SQL).prepare(transform="none", params={"t": 0.6}).serve(
        name="bulk", max_latency_ms=100, max_coalesce=1500,
    )
    small = db.sql(SQL).prepare(transform="sql", params={"t": 0.6}).serve(
        name="small", max_latency_ms=5,
    )
    bulk.submit(_batch(1500, seed=0)).wait(timeout=60)
    small.submit(_batch(32, seed=1)).wait(timeout=60)
    bulk_reqs = [bulk.submit(_batch(1500, seed=10 + i)) for i in range(4)]
    lats = []
    for i in range(10):
        r = small.submit(_batch(32, seed=50 + i))
        r.wait(timeout=60.0)
        lats.append(r.latency_s)
        time.sleep(0.005)
    for r in bulk_reqs:
        r.wait(timeout=120.0)
    stats = db.cache_stats()["server"]
    assert stats["pipeline"]["groups_started"] >= 6
    assert max(lats) < 5.0, f"small-query latency {max(lats) * 1e3:.1f} ms"


def test_pipelined_execution_zero_new_traces_on_warm_buckets(hospital, pipes, db):
    """Warmed through the pump, requests landing on the warm bucket trace
    nothing more; the counts equal the reference's over the same requests."""
    ref_db = jraven.connect(hospital.tables, stats="auto")
    ref_db.register_model("m", pipes[0])
    try:
        counts = []
        for sess in (ref_db, db):
            reng.clear_plan_cache()
            teng.clear_plan_cache()
            prep = sess.sql(SQL).prepare(transform="none", params={"t": 0.6}).serve(
                name="warm_udf", max_latency_ms=3,
            )
            prep.submit(_batch(100, seed=1)).wait(timeout=60.0)
            warm = sess.cache_stats()
            for i, n in enumerate((65, 128, 80, 127)):  # all land in bucket 128
                prep.submit(_batch(n, seed=30 + i)).wait(timeout=60.0)
            stats = sess.cache_stats()
            assert stats["traces"] == warm["traces"] >= 2
            assert stats["stage_traces"] == warm["stage_traces"]
            assert stats["server"]["pipelined_groups"] >= 1
            counts.append(stats["traces"])
        assert counts[0] == counts[1]
    finally:
        ref_db.close()


def test_serial_and_pipelined_results_identical_and_the_references(hospital, pipes, db):
    batches = [_batch(n, seed=60 + i) for i, n in enumerate((40, 90, 170))]
    outs = {}
    for mode in (False, True):
        srv = PredictionQueryServer(pipelined=mode, device="cpu")
        prep = db.sql(SQL).prepare(transform="none", params={"t": 0.6}).serve(
            name="ab", server=srv,
        )
        reqs = [prep.submit(b) for b in batches]
        srv.flush()
        outs[mode] = [r.result for r in reqs]
        srv.shutdown()
    ref_db = jraven.connect(hospital.tables, stats="auto")
    ref_db.register_model("m", pipes[0])
    try:
        ref_prep = ref_db.sql(SQL).prepare(transform="none", params={"t": 0.6}).serve()
        ref_reqs = [ref_prep.submit(b) for b in batches]
        ref_db.flush()
    finally:
        ref_db.close()
    for a, b, r in zip(outs[False], outs[True], ref_reqs):
        assert sorted(a) == sorted(b) == sorted(r.result)
        for k in a:
            assert np.array_equal(a[k], b[k])
            np.testing.assert_allclose(np.asarray(a[k], np.float64), r.result[k],
                                       rtol=1e-6)


def test_forced_donation_drops_the_consumed_inputs_and_changes_nothing(db, monkeypatch):
    """``RAVEN_DONATE=1`` on the CPU: the entry stage's single-use inputs
    leave the env after it (later stages key without them); results are
    identical."""
    ref_srv = PredictionQueryServer(device="cpu")
    db.sql(SQL).prepare(transform="none", params={"t": 0.6}).serve(name="don_ref",
                                                                    server=ref_srv)
    b = _batch(200, seed=9)
    want = ref_srv.execute("don_ref", b)
    monkeypatch.setenv("RAVEN_DONATE", "1")
    teng.clear_plan_cache()
    don_srv = PredictionQueryServer(device="cpu")
    prep = db.sql(SQL).prepare(transform="none", params={"t": 0.6}).serve(
        name="don_on", server=don_srv)
    got = don_srv.execute("don_on", b)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k])
    # the post-boundary stage keyed without the fact table and validity
    keys = [k for k in teng.PLAN_CACHE_STATS.stage_traces]
    assert len(keys) == 2 and prep.compiled.traces == 2
