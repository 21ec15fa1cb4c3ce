"""The port's query server (``PredictionQueryServer`` and the front door's
``prep.serve()`` → ``submit`` → ``flush``) against the reference's, on the
CPU.

Both servers register the same query over the same tables (pipelines are
trained by the reference and carried over through its save format) and
serve the same batches. Their results agree: a decision tree's scores and
labels exactly, a boosted ensemble's within ``rtol=1e-5`` (another order of
the sums), COUNTs exactly. Their accounting agrees too: recompiles (the
reference's jit traces; the port's new input structures on the CPU, its
captures on the card), bucket and mid-bucket hits and misses, coalesced and
segmented batches. The cases follow ``tests/test_query_server.py``; the
model-version lifecycle (ROADMAP item 7) is held against the reference
here verb by verb and in ``tests/test_torch_lifecycle.py`` in depth.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

import repro as jraven
from repro.core.ir import TableStats as RefTableStats
from repro.core.optimizer import OptimizerOptions as RefOptions
from repro.data.datasets import make_hospital
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.relational import engine as reng
from repro.serve import PredictionQueryServer as RefServer
from repro.serve import row_bucket as ref_row_bucket
from repro.serve.query_server import canonical_dtype as ref_canonical_dtype
from repro.sql.parser import parse_prediction_query as ref_parse

import repro_torch as raven
from repro_torch.core.ir import TableStats
from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
from repro_torch.errors import StaleQueryError, UnknownQueryError
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.options import ServeOptions
from repro_torch.relational import engine as teng
from repro_torch.serve import PredictionQueryServer, row_bucket
from repro_torch.serve.query_server import canonical_dtype
from repro_torch.sql.parser import parse_prediction_query

SQL_STAR = "SELECT * FROM PREDICT(model='m', data=patients) AS p WHERE score >= 0.6"
SQL_AGG = ("SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) AS p "
           "WHERE score >= 0.6")
SQL_PARAM = "SELECT * FROM PREDICT(model='m', data=patients) AS p WHERE score >= :t"


@pytest.fixture(scope="module")
def pipes(hospital, hospital_dt, hospital_gb, tmp_path_factory):
    out = {}
    for kind, ref_pipe in (("dt", hospital_dt), ("gb", hospital_gb)):
        path = str(tmp_path_factory.mktemp(kind) / f"{kind}.npz")
        ref_save_pipeline(ref_pipe, path)
        out[kind] = (ref_pipe, load_pipeline(path))
    return out


def _queries(hospital, pipes, sql=SQL_STAR, kind="dt"):
    ref_pipe, port_pipe = pipes[kind]
    t = hospital.tables["patients"]
    ref_q = ref_parse(sql, {"m": ref_pipe}, hospital.tables,
                      stats={"patients": RefTableStats.of(t)})
    q = parse_prediction_query(sql, {"m": port_pipe}, hospital.tables,
                               stats={"patients": TableStats.of(t)})
    return ref_q, q


def _servers(transform, **kw):
    """The two servers, over cleared plan caches: each counts only what its
    own requests specialize."""
    reng.clear_plan_cache()
    teng.clear_plan_cache()
    return (RefServer(options=RefOptions(transform=transform), **kw),
            PredictionQueryServer(options=OptimizerOptions(transform=transform),
                                  device="cpu", **kw))


def _batch(n, seed):
    return make_hospital(n, seed=seed).tables["patients"]


def _assert_close(got: dict, want: dict, rtol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = np.asarray(got[k])
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=rtol, atol=1e-6)
        else:
            assert np.array_equal(g, w), k


# ---------------------------------------------------------------------------
# Buckets and schemas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,min_bucket", [(1, 64), (64, 64), (65, 64), (1000, 64),
                                          (0, 8), (4097, 64)])
def test_row_bucket_as_the_reference(n, min_bucket):
    assert row_bucket(n, min_bucket) == ref_row_bucket(n, min_bucket)


@pytest.mark.parametrize("dt", ["float64", "float32", "int64", "int32", "uint64", "bool",
                                "int16"])
def test_canonical_dtype_as_the_reference(dt):
    assert canonical_dtype(np.dtype(dt)) == ref_canonical_dtype(np.dtype(dt))


# ---------------------------------------------------------------------------
# One server against the other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sql,transform,kind", [
    (SQL_STAR, "sql", "dt"), (SQL_AGG, "sql", "dt"), (SQL_STAR, "none", "dt"),
    (SQL_AGG, "none", "gb"), (SQL_STAR, "dnn", "gb"), (SQL_AGG, "dnn", "gb"),
], ids=["rows-sql", "agg-sql", "rows-none", "agg-none", "rows-dnn", "agg-dnn"])
def test_server_matches_the_reference_server(hospital, pipes, sql, transform, kind):
    ref_q, q = _queries(hospital, pipes, sql, kind)
    ref, srv = _servers(transform)
    ref.register("risk", ref_q, hospital.tables)
    srv.register("risk", q, hospital.tables)
    for seed, n in ((9, 300), (10, 1)):
        rows = _batch(n, seed)
        _assert_close(srv.execute("risk", rows), ref.execute("risk", rows))
    assert srv.recompiles() == ref.recompiles() > 0


def test_server_zero_recompiles_after_warmup_as_the_reference(hospital, pipes):
    """From cleared plan caches: one specialization a new bucket and none
    for a warm one (the reference's jit traces; on the card, captures), the
    same totals and bucket hits as the reference after every request."""
    ref_q, q = _queries(hospital, pipes)
    ref, srv = _servers("sql")
    ref.register("risk", ref_q, hospital.tables)
    srv.register("risk", q, hospital.tables)
    for i, n in enumerate((100, 65, 128, 80, 127, 200, 129, 1, 64)):
        b = _batch(n, seed=50 + i)
        _assert_close(srv.execute("risk", b), ref.execute("risk", b))
        assert srv.recompiles() == ref.recompiles(), n
        assert (srv.stats.bucket_misses, srv.stats.bucket_hits) == (
            ref.stats.bucket_misses, ref.stats.bucket_hits), n
    assert srv.recompiles() == 3  # buckets 128, 256 and 64
    assert (srv.stats.bucket_misses, srv.stats.bucket_hits) == (3, 6)


def test_server_shares_optimized_plan_across_registrations(hospital, pipes):
    ref_q, q = _queries(hospital, pipes)
    srv = PredictionQueryServer(options=OptimizerOptions(transform="sql"), device="cpu")
    a = srv.register("a", q, hospital.tables)
    b = srv.register("b", q.copy(), hospital.tables)
    assert (srv.stats.plan_cache_misses, srv.stats.plan_cache_hits) == (1, 1)
    assert a.plan is b.plan and a.compiled is b.compiled
    assert a.token != b.token


def test_server_microbatch_matches_per_request_and_the_reference(hospital, pipes):
    ref_q, q = _queries(hospital, pipes)
    ref, srv = _servers("sql")
    ref.register("risk", ref_q, hospital.tables)
    srv.register("risk", q, hospital.tables)
    sizes = (50, 40, 30, 60)
    batches = [_batch(n, seed=40 + i) for i, n in enumerate(sizes)]
    reqs = [srv.submit("risk", b) for b in batches]
    ref_reqs = [ref.submit("risk", b) for b in batches]
    srv.flush()
    ref.flush()
    assert srv.stats.coalesced_requests == ref.stats.coalesced_requests == len(sizes)
    assert srv.stats.batches_executed == ref.stats.batches_executed == 1
    solo = PredictionQueryServer(options=OptimizerOptions(transform="sql"), device="cpu")
    solo.register("risk", q, hospital.tables)
    for req, ref_req, b in zip(reqs, ref_reqs, batches):
        assert req.done and req.latency_s > 0
        _assert_close(req.result, ref_req.result)
        _assert_close(req.result, solo.execute("risk", b))


def test_server_aggregate_and_udf_paths_with_segment_ids(hospital, pipes):
    """Aggregates and host-boundary (UDF) plans coalesce via segment ids:
    one padded execution per flush, split back per request; each answer
    the reference server's."""
    agg_ref_q, agg_q = _queries(hospital, pipes, SQL_AGG)
    udf_ref_q, udf_q = _queries(hospital, pipes, SQL_STAR)
    for transform, (ref_q, q) in (("sql", (agg_ref_q, agg_q)), ("none", (udf_ref_q, udf_q))):
        ref, srv = _servers(transform)
        ref.register("q", ref_q, hospital.tables)
        srv.register("q", q, hospital.tables)
        batches = [_batch(200, seed=8), _batch(77, seed=9), _batch(1, seed=11)]
        reqs = [srv.submit("q", b) for b in batches]
        ref_reqs = [ref.submit("q", b) for b in batches]
        srv.flush()
        ref.flush()
        for key in ("batches_executed", "segmented_batches", "coalesced_requests",
                    "mid_bucket_misses", "mid_bucket_hits"):
            assert getattr(srv.stats, key) == getattr(ref.stats, key), key
        assert srv.stats.segmented_batches == 1
        for r, rr in zip(reqs, ref_reqs):
            _assert_close(r.result, rr.result)


def test_server_coalesces_aggregates_with_segment_ids(hospital, pipes):
    """Two aggregate requests share one segmented execution, each getting its
    own fold, as when served alone (the reference's rtol)."""
    _, q = _queries(hospital, pipes, SQL_AGG)
    srv = PredictionQueryServer(options=OptimizerOptions(transform="sql"), device="cpu")
    srv.register("agg", q, hospital.tables)
    b1, b2 = _batch(150, seed=21), _batch(90, seed=22)
    r1, r2 = srv.submit("agg", b1), srv.submit("agg", b2)
    srv.flush()
    assert srv.stats.batches_executed == 1 and srv.stats.segmented_batches == 1
    solo = PredictionQueryServer(options=OptimizerOptions(transform="sql"), device="cpu")
    solo.register("agg", q, hospital.tables)
    for req, b in ((r1, b1), (r2, b2)):
        ref = solo.execute("agg", b)
        for k in ref:
            assert req.result[k].shape == ref[k].shape
            np.testing.assert_allclose(req.result[k], ref[k], rtol=1e-4)


def test_mid_bucketing_keeps_post_udf_stages_warm_as_the_reference(hospital, pipes):
    """Host-boundary outputs are re-padded to a power-of-two bucket, so the
    stage after the boundary specializes per bucket, not per compacted row
    count: the same recompiles and mid-bucket hits as the reference."""
    ref_q, q = _queries(hospital, pipes, SQL_STAR)
    ref, srv = _servers("none")
    ref.register("u", ref_q, hospital.tables)
    srv.register("u", q, hospital.tables)
    for i, n in enumerate((90, 100, 110, 70, 300)):
        b = _batch(n, seed=60 + i)
        _assert_close(srv.execute("u", b), ref.execute("u", b))
        assert srv.recompiles() == ref.recompiles()
        assert (srv.stats.mid_bucket_hits, srv.stats.mid_bucket_misses) == (
            ref.stats.mid_bucket_hits, ref.stats.mid_bucket_misses)
    assert srv.stats.mid_bucket_hits > 0


def test_server_validates_batch_schema(hospital, pipes):
    _, q = _queries(hospital, pipes)
    srv = PredictionQueryServer(options=OptimizerOptions(transform="sql"), device="cpu")
    srv.register("risk", q, hospital.tables)
    with pytest.raises(KeyError):
        srv.submit("risk", {"age": np.zeros(4)})
    ragged = dict(_batch(10, seed=2))
    ragged["age"] = ragged["age"][:7]
    with pytest.raises(ValueError, match="ragged"):
        srv.submit("risk", ragged)
    with pytest.raises(UnknownQueryError):
        srv.submit("nope", _batch(3, seed=1))


def test_server_chunks_oversized_batches(hospital, pipes):
    ref_q, q = _queries(hospital, pipes)
    ref, srv = _servers("sql", min_bucket=8, max_bucket=64)
    ref.register("risk", ref_q, hospital.tables)
    srv.register("risk", q, hospital.tables)
    srv.execute("risk", _batch(64, seed=1))  # warm the max_bucket program
    warm = srv.recompiles()
    rows = _batch(200, seed=7)  # 200 > max_bucket: 64+64+64+8-bucket chunks
    got = srv.execute("risk", rows)
    # only the 8-row tail bucket is new; no bucket above 64 specialized
    assert srv.recompiles() == warm + 1
    assert all(b <= 64 for _, _, b in srv._seen_buckets)
    _assert_close(got, ref.execute("risk", rows))


@pytest.mark.parametrize("sql", [SQL_STAR, SQL_AGG], ids=["rows", "agg"])
def test_padded_execution_equals_unpadded(hospital, pipes, sql):
    _, q = _queries(hospital, pipes, sql)
    plan, _ = RavenOptimizer(options=OptimizerOptions(transform="sql")).optimize(q)
    ref = teng.execute_plan(plan, hospital.tables, device="cpu").to_numpy()
    n = hospital.n_rows()
    pad = 513  # non-power-of-two padding, pad rows full of zeros
    tables = {t: dict(cols) for t, cols in hospital.tables.items()}
    tables["patients"] = {c: np.concatenate([v, np.zeros(pad, v.dtype)])
                          for c, v in hospital.tables["patients"].items()}
    got = teng.execute_plan(plan, tables, row_valid=np.arange(n + pad) < n,
                            device="cpu").to_numpy()
    _assert_close(got, ref)


# ---------------------------------------------------------------------------
# The front door: prep.serve() -> submit -> flush
# ---------------------------------------------------------------------------


@pytest.fixture()
def sessions(hospital, pipes):
    reng.clear_plan_cache()
    teng.clear_plan_cache()
    ref_db = jraven.connect(hospital.tables, stats="auto")
    ref_db.register_model("m", pipes["gb"][0])
    db = raven.connect(hospital.tables, stats="auto", device="cpu")
    db.register_model("m", pipes["gb"][1])
    yield ref_db, db
    ref_db.close()
    db.close()


@pytest.mark.parametrize("transform", ["dnn", "sql", "none"])
def test_served_front_door_equals_one_shot_and_the_reference(sessions, transform):
    ref_db, db = sessions
    ref_prep = ref_db.sql(SQL_PARAM).prepare(transform=transform, params={"t": 0.6}).serve()
    prep = db.sql(SQL_PARAM).prepare(transform=transform, params={"t": 0.6}).serve()
    assert prep.name is not None and "serve:" in prep.explain()
    batches = [_batch(n, seed=70 + i) for i, n in enumerate((33, 1, 250, 64))]
    reqs = [prep.submit(b) for b in batches]
    ref_reqs = [ref_prep.submit(b) for b in batches]
    assert [r.done for r in db.flush()] == [True] * len(batches)
    ref_db.flush()
    stats = db.cache_stats()
    assert stats["server"]["recompiles"] == ref_db.cache_stats()["server"]["recompiles"]
    assert {"queue_depths", "pipeline", "overloads"} <= set(stats["server"])
    for r, rr, b in zip(reqs, ref_reqs, batches):
        _assert_close(r.result, rr.result)
        _assert_close(r.result, prep(b))


def test_served_rebind_flows_into_the_next_group(sessions):
    ref_db, db = sessions
    ref_prep = ref_db.sql(SQL_PARAM).prepare(transform="sql", params={"t": 0.6}).serve()
    prep = db.sql(SQL_PARAM).prepare(transform="sql", params={"t": 0.6}).serve()
    b = _batch(300, seed=3)
    first = db.server.execute(prep.name, b)
    recompiles = db.server.recompiles()
    prep.bind(t=0.2)
    ref_prep.bind(t=0.2)
    again = db.server.execute(prep.name, b)
    assert len(again["score"]) > len(first["score"])
    assert db.server.recompiles() == recompiles  # a value, not a shape
    _assert_close(again, ref_db.server.execute(ref_prep.name, b))


def test_a_stale_handle_is_refused(sessions):
    _, db = sessions
    old = db.sql(SQL_PARAM).prepare(transform="sql", params={"t": 0.6}).serve(name="q")
    db.sql(SQL_PARAM).prepare(transform="sql", params={"t": 0.5}).serve(name="q")
    with pytest.raises(StaleQueryError):
        old.submit(_batch(4, seed=1))


def test_submit_before_serve_raises(sessions):
    _, db = sessions
    prep = db.sql(SQL_PARAM).prepare(transform="sql", params={"t": 0.6})
    with pytest.raises(raven.RavenError, match="serve"):
        prep.submit(_batch(4, seed=1))
    assert db.flush() == []


def test_undonated_registration_serves_the_same(sessions):
    _, db = sessions
    a = db.sql(SQL_PARAM).prepare(transform="sql", params={"t": 0.6}).serve(name="a")
    b = db.sql(SQL_PARAM).prepare(transform="sql", params={"t": 0.6}).serve(
        name="b", options=ServeOptions(donate=False))
    batch = _batch(90, seed=5)
    ra, rb = a.submit(batch), b.submit(batch)
    db.flush()
    _assert_close(ra.result, rb.result, rtol=0)


def _v2(db, pipes) -> None:
    """Serve ``SQL_PARAM`` as ``q``, answer one request, publish model
    ``m`` v2 (the decision tree) without warming it, and stage it on the
    route through the server's ``stage_version``."""
    is_ref = isinstance(db, jraven.Session)
    db.sql(SQL_PARAM).prepare(transform="sql", params={"t": 0.6}).serve(name="q")
    db.server.submit("q", _batch(90, seed=5))
    db.flush()
    db.models.publish("m", pipes["dt"][0 if is_ref else 1], warm="off")
    q2 = db.sql(SQL_PARAM.replace("'m'", "'m@2'"))
    v2 = q2.prepare(transform="sql", params={"t": 0.6})
    db.server.stage_version("q", q2.ir, db.tables if is_ref else db.database,
                            version_label="v2", optimized=(v2.plan, v2.report))


def _route_state(db) -> dict:
    snap = db.server.route_snapshot("q")
    keep = ("warmed", "traces", "groups", "requests", "rows", "shadow_groups",
            "shadow_rows", "shadow_diff_rows", "shadow_errors")
    return {"live": snap["live"], "shadow": snap["shadow"], "split": snap["split"],
            "cutovers": snap["cutovers"], "ladder": snap["ladder"],
            "versions": {lb: {k: v[k] for k in keep} for lb, v in snap["versions"].items()}}


def _answer(db, n=90, seed=6):
    req = db.server.submit("q", _batch(n, seed=seed))
    db.flush()
    return req.served_by, req.wait(timeout=60.0)


def _shadowed(db):
    db.server.warm_version("q", "v2")
    db.server.set_shadow("q", "v2")
    out = _answer(db)
    deadline = time.monotonic() + 30
    while (db.server.route_snapshot("q")["versions"]["v2"]["shadow_groups"] < 1
           and time.monotonic() < deadline):
        time.sleep(0.01)  # the mirror runs on the boundary pool
    return out


def _split(db):
    db.server.warm_version("q", "v2")
    db.server.set_split("q", {"v2": 0.25})
    return [_answer(db, seed=7 + i)[0] for i in range(8)]


def _cutover(db):
    db.server.warm_version("q", "v2")
    before = db.server.recompiles()
    db.server.cutover("q", "v2")
    out = _answer(db)
    return out, db.server.recompiles() - before


def _retire(db):
    with pytest.raises(Exception, match="live") as ei:
        db.server.retire_version("q", "v1")
    db.server.retire_version("q", "v2")
    return type(ei.value).__name__, _answer(db)


LIFECYCLE = {
    "stage_version": lambda db: sorted(db.server.routes["q"].versions),
    "warm_version": lambda db: (db.server.warm_version("q", "v2"),
                                db.server.warm_version("q", "v2")),
    "set_shadow": _shadowed,
    "set_split": _split,
    "cutover": _cutover,
    "retire_version": _retire,
}


def _same(got, want):
    """Equal outcomes; float arrays within rtol 1e-5."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        if all(isinstance(v, np.ndarray) for v in want.values()):
            _assert_close(got, want)
        else:
            for k in want:
                _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("verb", sorted(LIFECYCLE))
def test_lifecycle_verbs_raise_naming_item_7(sessions, pipes, verb):
    """The server's six route verbs (ROADMAP item 7, ported) on both
    servers, with v2 staged on the route: the same outcome (served-by
    labels, answers, counts) and the same route state after."""
    ref_db, db = sessions
    got = {}
    for side, d in (("ref", ref_db), ("port", db)):
        _v2(d, pipes)
        got[side] = (LIFECYCLE[verb](d), _route_state(d))
    _same(got["port"], got["ref"])


def test_a_circuit_breaker_raises_naming_item_7(sessions):
    """``breaker_threshold`` (ROADMAP item 7, ported) arms the route's
    breaker as the reference's does."""
    ref_db, db = sessions
    for d, pkg in ((ref_db, jraven), (db, raven)):
        prep = d.sql(SQL_PARAM).prepare(transform="sql", params={"t": 0.6})
        prep.serve(name="q", options=pkg.ServeOptions(breaker_threshold=3))
    for d in (ref_db, db):
        reg = d.server.queries["q"]
        assert (reg.breaker_threshold, reg.breaker_failures, reg.degraded) == (3, 0, False)
    assert (db.server.route_snapshot("q")["versions"]["v1"]["breaker_trips"]
            == ref_db.server.route_snapshot("q")["versions"]["v1"]["breaker_trips"] == 0)
