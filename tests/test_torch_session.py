"""The port's front door (``repro_torch.connect`` → ``db.sql`` / the builder
→ ``prepare`` → the one-shot call, ``bind`` and ``explain``) against the
reference's ``repro.session`` on the same tables and pipelines, on the CPU.

Pipelines are trained by the reference and carried over through its save
format. Both sessions prepare with ``transform="dnn"`` unless a test says
otherwise (``"sql"``, or the default ``"none"``); COUNTs must be equal and AVGs within ``rtol=1e-5`` (the port and the
reference sum the trees in another order; thresholds sit mid-way in wide
gaps between scores, so last-bit differences move no row across them).
Fingerprints are compared within each package: the two hash their own
content tokens. The typed errors are the reference's. The session paths of
ROADMAP items 7 (the artifact store, the fault plan, the model lifecycle,
``recover``), 8 (verification) and 9 (runtime selection) are ported: each
runs on both sessions with the same outcome.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest

import repro as jraven
import repro.ml as jml
import repro_torch as raven
from repro.data.datasets import make_expedia, make_hospital
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro_torch import errors as terrors
from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
from repro.exec import faults as jfaults
from repro.relational import engine as jengine
from repro_torch.exec.faults import FaultPlan, get_fault_plan
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.options import ConnectOptions
from repro_torch.relational import engine as teng

QUICKSTART = """
    SELECT COUNT(*), AVG(score)
    FROM PREDICT(model = 'covid_risk', data = patients) AS p
    WHERE asthma = 1 AND score >= :threshold
"""
JOIN_QUERY = (
    "SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=searches "
    "JOIN hotels ON hotel_id = hotel_id "
    "JOIN destinations ON dest_id = dest_id) AS p "
    "WHERE s_cat0 = 3 AND score >= :t"
)


def _gap_thresholds(scores, quantiles, min_gap: float = 2e-5):
    """Bindings mid-way in the widest gap between consecutive scores near
    each quantile."""
    s = np.unique(np.asarray(scores, np.float64))
    out = []
    for q in quantiles:
        i = int(q * (len(s) - 2))
        j = i + int(np.argmax(np.diff(s[i : i + 201])))
        assert s[j + 1] - s[j] >= min_gap
        out.append(float(np.float32((s[j] + s[j + 1]) / 2)))
    return out


def _carry(ref_pipe, tmp_path_factory, name):
    path = str(tmp_path_factory.mktemp("m") / f"{name}.npz")
    ref_save_pipeline(ref_pipe, path)
    return load_pipeline(path)


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    """The quickstart's data and pipeline (scaler + one-hot + gradient
    boosting), at a test's size."""
    ds = make_hospital(2000, seed=0)
    ref_pipe = jml.fit_pipeline(
        ds.joined_columns(), ds.label, ds.numeric, ds.categorical,
        jml.GradientBoostingClassifier(n_estimators=20, max_depth=3),
        categories=ds.categories(),
    )
    port_pipe = _carry(ref_pipe, tmp_path_factory, "gb")
    cols = ds.joined_columns()
    score = np.asarray(jml.run_pipeline(ref_pipe, cols)[ref_pipe.outputs[0]]).reshape(-1)
    return ds, ref_pipe, port_pipe, score


@pytest.fixture()
def sessions(quickstart):
    ds, ref_pipe, port_pipe, _ = quickstart
    ref_db = jraven.connect(ds.tables, stats="auto")
    ref_db.register_model("covid_risk", ref_pipe)
    db = raven.connect(ds.tables, stats="auto", device="cpu")
    db.register_model("covid_risk", port_pipe)
    return ref_db, db


@pytest.fixture(scope="module")
def expedia(tmp_path_factory):
    ds = make_expedia(1024, seed=2)
    ref_pipe = jml.fit_pipeline(
        ds.joined_columns(), ds.label, ds.numeric, ds.categorical,
        jml.LogisticRegression(alpha=0.003, n_iter=120), categories=ds.categories(),
    )
    return ds, ref_pipe, _carry(ref_pipe, tmp_path_factory, "lr")


def _values(out: dict) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_agg_close(got: dict, want: dict):
    assert sorted(got) == sorted(want) == ["count_rows", "mean_score"]
    assert got["count_rows"][0] > 0
    assert np.array_equal(got["count_rows"], want["count_rows"])
    np.testing.assert_allclose(got["mean_score"], want["mean_score"], rtol=1e-5)


# ---------------------------------------------------------------------------
# The quickstart's query, prepared through both front doors
# ---------------------------------------------------------------------------


def test_quickstart_query_matches_reference(quickstart, sessions):
    ds, _, _, score = quickstart
    ref_db, db = sessions
    t0, t1 = _gap_thresholds(score[ds.tables["patients"]["asthma"] == 1], (0.3, 0.7))
    ref_prep = ref_db.sql(QUICKSTART).prepare(transform="dnn", params={"threshold": t0})
    prep = db.sql(QUICKSTART).prepare(transform="dnn", params={"threshold": t0})
    _assert_agg_close(_values(prep()), _values(ref_prep()))
    prep.bind(threshold=t1)
    ref_prep.bind(threshold=t1)
    _assert_agg_close(_values(prep()), _values(ref_prep()))


def test_connect_with_optimizer_options_sets_the_default_transform(quickstart):
    ds, _, port_pipe, _ = quickstart
    for options in (OptimizerOptions(transform="dnn"),
                    ConnectOptions(optimizer=OptimizerOptions(transform="dnn"),
                                   partition_cols={"patients": "asthma"})):
        db = raven.connect(ds.tables, options=options, device="cpu")
        db.register_model("covid_risk", port_pipe)
        prep = db.sql(QUICKSTART).prepare(params={"threshold": 0.5})
        assert prep.report.transforms == {0: "dnn"}
        assert db.stats["patients"].partition_col == (
            "asthma" if isinstance(options, ConnectOptions) else None)


def test_default_transform_resolves_to_none_and_matches_reference(quickstart, sessions):
    """No transform and no strategy: the interpreted runtime behind one
    MLUdf (``pure, host, pure``), as in the reference."""
    ds, _, _, score = quickstart
    ref_db, db = sessions
    t0, t1 = _gap_thresholds(score[ds.tables["patients"]["asthma"] == 1], (0.3, 0.7))
    prep = db.sql(QUICKSTART).prepare(params={"threshold": t0})
    ref_prep = ref_db.sql(QUICKSTART).prepare(params={"threshold": t0})
    assert prep.report.transforms == ref_prep.report.transforms == {0: "none"}
    assert [s.kind for s in prep.compiled.stages] == ["pure", "host", "pure"] == [
        s.kind for s in ref_prep.compiled.graph.stages]
    _assert_agg_close(_values(prep()), _values(ref_prep()))
    prep.bind(threshold=t1)
    ref_prep.bind(threshold=t1)
    _assert_agg_close(_values(prep()), _values(ref_prep()))
    plan, report = RavenOptimizer(options=OptimizerOptions()).optimize(db.sql(QUICKSTART).ir)
    assert report.transforms == {0: "none"}
    assert any(isinstance(p, teng.MLUdf) for p in teng.walk_plan(plan))
    # a strategy (ROADMAP item 9, ported) picks the runtime where none is forced
    plan, report = RavenOptimizer(strategy=_Always("sql")).optimize(db.sql(QUICKSTART).ir)
    assert report.transforms == {0: "sql"}
    assert not any(isinstance(p, teng.MLUdf) for p in teng.walk_plan(plan))


def test_sql_transform_matches_reference(quickstart, sessions):
    """MLtoSQL: the model as CASE expressions in one pure stage; the score
    filter moves to logit space, AVG(score) reads probabilities."""
    ds, _, _, score = quickstart
    ref_db, db = sessions
    t0, t1 = _gap_thresholds(score[ds.tables["patients"]["asthma"] == 1], (0.3, 0.7))
    prep = db.sql(QUICKSTART).prepare(transform="sql", params={"threshold": t0})
    ref_prep = ref_db.sql(QUICKSTART).prepare(transform="sql", params={"threshold": t0})
    assert prep.report.stages == ref_prep.report.stages
    assert prep.report.notes == ref_prep.report.notes
    assert prep.compiled.graph.is_pure and "Project" in prep.report.stages[0]
    _assert_agg_close(_values(prep()), _values(ref_prep()))
    prep.bind(threshold=t1)
    ref_prep.bind(threshold=t1)
    _assert_agg_close(_values(prep()), _values(ref_prep()))
    text = prep.explain()
    assert "predict[0] -> sql" in text and "ops on sql" in text


# ---------------------------------------------------------------------------
# Query construction: SQL text and fluent builder are one front door
# ---------------------------------------------------------------------------


def test_sql_and_builder_fingerprint_identical(sessions):
    for db in sessions:
        sql = db.sql(QUICKSTART)
        built = (
            db.table("patients").predict("covid_risk")
            .where("asthma = 1").where("score >= :threshold")
            .select("COUNT(*)", "AVG(score)")
        )
        assert sql.fingerprint() == built.fingerprint()
        assert sql.param_names() == built.param_names() == {"threshold"}


def test_sql_and_builder_fingerprint_identical_with_joins(expedia):
    ds, ref_pipe, port_pipe = expedia
    for pkg, pipe in ((jraven, ref_pipe), (raven, port_pipe)):
        kw = {} if pkg is jraven else {"device": "cpu"}
        db = pkg.connect(ds.tables, stats=None, **kw)
        db.register_model("m", pipe)
        sql = db.sql(JOIN_QUERY)
        built = (
            db.table("searches")
            .join("hotels", on="hotel_id")
            .join("destinations", on=("dest_id", "dest_id"))
            .predict("m")
            .where("s_cat0 = 3").where("score >= :t")
            .select("COUNT(*)", "AVG(score)")
        )
        assert sql.fingerprint() == built.fingerprint()
        assert sql.param_names() == {"t"}


def test_builder_string_literal_matches_sql(sessions):
    _, db = sessions
    sql = db.sql(
        "SELECT * FROM PREDICT(model='covid_risk', data=patients) WHERE blood_type = 'A'"
    )
    built = db.table("patients").predict("covid_risk").where("blood_type", "=", "A")
    assert sql.fingerprint() == built.fingerprint()


def test_param_name_not_value_in_fingerprint(sessions):
    _, db = sessions
    with_param = db.sql(
        "SELECT * FROM PREDICT(model='covid_risk', data=patients) WHERE score >= :t"
    )
    with_const = db.sql(
        "SELECT * FROM PREDICT(model='covid_risk', data=patients) WHERE score >= 0.6"
    )
    assert with_param.fingerprint() != with_const.fingerprint()
    a = with_param.prepare(transform="dnn", params={"t": 0.2})
    b = with_param.prepare(transform="dnn", params={"t": 0.8})
    assert a.fingerprint == b.fingerprint


# ---------------------------------------------------------------------------
# Prepare + execute + re-bind
# ---------------------------------------------------------------------------


def test_prepared_query_counts_match_host_scores(quickstart, sessions):
    _, _, _, score = quickstart
    _, db = sessions
    (t,) = _gap_thresholds(score, (0.5,))
    prep = db.sql(
        "SELECT COUNT(*) FROM PREDICT(model='covid_risk', data=patients) WHERE score >= :t"
    ).prepare(transform="dnn", params={"t": t})
    assert float(prep()["count_rows"][0]) == (score >= t).sum()


def test_rebind_reuses_compiled_plan_with_no_new_compile(quickstart, sessions, monkeypatch):
    _, _, _, score = quickstart
    _, db = sessions
    lo, hi = _gap_thresholds(score, (0.2, 0.9))
    prep = db.sql(
        "SELECT COUNT(*) FROM PREDICT(model='covid_risk', data=patients) WHERE score >= :t"
    ).prepare(transform="dnn", params={"t": lo})
    n_lo = float(prep()["count_rows"][0])
    builds = []
    real = teng._build_compiled
    monkeypatch.setattr(teng, "_build_compiled", lambda *a: builds.append(a) or real(*a))
    compiled, fp = prep.compiled, prep.fingerprint
    misses = db.cache_stats()["misses"]
    stage_calls = prep.compiled.stages[0].calls
    prep.bind(t=hi)
    n_hi = float(prep()["count_rows"][0])
    assert not builds and db.cache_stats()["misses"] == misses  # nothing compiled
    assert prep.compiled is compiled and prep.fingerprint == fp
    assert prep.compiled.stages[0].calls == stage_calls + 1  # the same stage ran
    assert n_lo == (score >= lo).sum() and n_hi == (score >= hi).sum() and n_lo > n_hi


def test_tables_go_to_the_device_once(sessions, monkeypatch):
    """A call uploads nothing but its batch: the session's tables went to
    its device at connect."""
    from repro_torch.relational import table

    _, db = sessions
    assert isinstance(db.database, teng.Database) and db.database.device.type == "cpu"
    prep = db.sql(QUICKSTART).prepare(transform="dnn", params={"threshold": 0.5})
    uploads = []
    real = table.to_device
    monkeypatch.setattr(table, "to_device", lambda *a: uploads.append(a) or real(*a))
    monkeypatch.setattr(teng, "to_device", table.to_device)
    prep()
    prep()
    assert uploads == []
    batch = make_hospital(64, seed=4).tables["patients"]
    prep(batch)
    assert {id(a[0]) for a in uploads} == {id(v) for v in batch.values()}  # the batch only


def test_one_shot_on_fresh_batch_matches_reference(quickstart, sessions):
    _, ref_pipe, _, _ = quickstart
    ref_db, db = sessions
    batch = make_hospital(333, seed=7).tables["patients"]
    oracle = np.asarray(jml.run_pipeline(ref_pipe, batch)[ref_pipe.outputs[0]]).reshape(-1)
    (t,) = _gap_thresholds(oracle, (0.5,), min_gap=1e-5)
    text = "SELECT * FROM PREDICT(model='covid_risk', data=patients) WHERE score >= :t"
    out = db.sql(text).prepare(transform="dnn", params={"t": t})(batch)
    want = ref_db.sql(text).prepare(transform="dnn", params={"t": t})(batch)
    assert sorted(out) == sorted(want)
    assert len(out["score"]) == (oracle >= t).sum() == len(want["score"])
    np.testing.assert_allclose(np.sort(out["score"]), np.sort(np.asarray(want["score"])),
                               atol=1e-5)


def test_batch_missing_a_column_raises(sessions):
    for db, err in zip(sessions, (jraven.RavenError, terrors.RavenError)):
        prep = db.sql(QUICKSTART).prepare(transform="dnn", params={"threshold": 0.5})
        batch = dict(make_hospital(50, seed=8).tables["patients"])
        del batch["age"]
        with pytest.raises(err, match="missing columns.*age"):
            prep(batch)


def test_join_query_one_shot_matches_reference(expedia):
    ds, ref_pipe, port_pipe = expedia
    ref_db = jraven.connect(ds.tables, stats="auto")
    ref_db.register_model("m", ref_pipe)
    db = raven.connect(ds.tables, stats="auto", device="cpu")
    db.register_model("m", port_pipe)
    cols = ds.joined_columns()
    score = np.asarray(jml.run_pipeline(ref_pipe, cols)[ref_pipe.outputs[0]]).reshape(-1)
    (t,) = _gap_thresholds(score, (0.3,), min_gap=1e-5)
    text = JOIN_QUERY.replace("s_cat0 = 3 AND ", "")
    prep = db.sql(text).prepare(transform="dnn", params={"t": t})
    ref_prep = ref_db.sql(text).prepare(transform="dnn", params={"t": t})
    _assert_agg_close(_values(prep()), _values(ref_prep()))
    # a batch replaces the fact table; the dim tables stay on the device
    batch = {c: v[: len(v) // 2] for c, v in ds.tables["searches"].items()}
    _assert_agg_close(_values(prep(batch)), _values(ref_prep(batch)))
    _assert_agg_close(_values(prep()), _values(ref_prep()))


# ---------------------------------------------------------------------------
# EXPLAIN
# ---------------------------------------------------------------------------


def test_explain_renders_runtimes_projections_and_notes(sessions):
    _, db = sessions
    prep = db.sql(QUICKSTART).prepare(transform="dnn", params={"threshold": 0.6})
    text = prep.explain()
    assert "predict[0] -> dnn" in text            # chosen runtime
    assert "logical plan" in text and "physical plan" in text
    assert "Scan[patients]" in text and "TensorOp[" in text
    assert "reads" in text and "columns" in text  # pushed projections
    assert ":threshold = 0.6" in text             # param binding shown
    assert "segment_agg" in text                  # relational runtime placement
    assert prep.report.notes and all(n in text for n in prep.report.notes)
    assert "covid_risk: live=v1" in text and "stage graph: 1 pure stage" in text


# ---------------------------------------------------------------------------
# Typed error paths: the reference's types
# ---------------------------------------------------------------------------

BAD_SQL = {
    "unknown model": "SELECT * FROM PREDICT(model='nope', data=patients)",
    "unknown table": "SELECT * FROM PREDICT(model='covid_risk', data=nosuch)",
    "unknown join table": ("SELECT * FROM PREDICT(model='covid_risk', data=patients "
                           "JOIN missing_dim ON asthma = asthma)"),
    "unknown column": ("SELECT * FROM PREDICT(model='covid_risk', data=patients) "
                       "WHERE not_a_col = 1"),
    "missing comma": "SELECT * FROM PREDICT(model='covid_risk' data=patients)",
    "missing model": "SELECT * FROM PREDICT(data=patients)",
    "unclosed paren": "SELECT * FROM PREDICT(model='covid_risk', data=patients",
    "no PREDICT": "SELECT * FROM patients",
    "unknown version": "SELECT * FROM PREDICT(model='covid_risk@7', data=patients)",
}


@pytest.mark.parametrize("case", sorted(BAD_SQL))
def test_bad_queries_raise_the_references_error_types(sessions, case):
    ref_db, db = sessions
    with pytest.raises(jraven.RavenError) as want:
        ref_db.sql(BAD_SQL[case])
    with pytest.raises(terrors.RavenError) as got:
        db.sql(BAD_SQL[case])
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value)  # message-bearing


def test_unknown_table_in_builder_raises(sessions):
    _, db = sessions
    with pytest.raises(terrors.UnknownTableError, match="nosuch"):
        db.table("nosuch")


def test_unbound_and_unknown_params_raise(sessions):
    ref_db, db = sessions
    for d, errs in ((ref_db, jraven), (db, raven)):
        q = d.sql("SELECT * FROM PREDICT(model='covid_risk', data=patients) WHERE score >= :t")
        with pytest.raises(errs.UnboundParameterError, match="t"):
            q.prepare(transform="dnn")
        with pytest.raises(errs.UnknownParameterError, match="zzz"):
            q.prepare(transform="dnn", params={"t": 0.5, "zzz": 1.0})
        prep = q.prepare(transform="dnn", params={"t": 0.5})
        with pytest.raises(errs.UnknownParameterError, match="zzz"):
            prep.bind(zzz=3.0)


def test_check_params_matches_reference():
    from repro.errors import check_params as ref_check

    for declared, bound, require_all in [({"t"}, {"t": 1}, True), ({"t", "u"}, {"t": 1}, True),
                                         ({"t"}, {"x": 1}, False), ({"t", "u"}, {"u": 2}, False),
                                         (set(), {}, True)]:
        try:
            ref_check(declared, bound, require_all=require_all)
            want = None
        except jraven.RavenError as e:
            want = (type(e).__name__, str(e))
        try:
            terrors.check_params(declared, bound, require_all=require_all)
            got = None
        except terrors.RavenError as e:
            got = (type(e).__name__, str(e))
        assert got == want


# ---------------------------------------------------------------------------
# The model registry's front-door part
# ---------------------------------------------------------------------------


def test_registry_publish_and_resolve_match_reference(quickstart):
    ds, ref_pipe, port_pipe, _ = quickstart
    ref_db = jraven.connect(ds.tables, stats=None)
    db = raven.connect(ds.tables, stats=None, device="cpu")
    for _ in range(3):
        ref_db.models.publish("r", ref_pipe, warm="off")
        db.models.publish("r", port_pipe, warm="off")
    reg = db.models
    assert "r" in reg and "r@2" in reg and "x" not in reg
    assert list(reg) == ["r"] and len(reg) == 1
    for ref in ("r", "r@live", "r@1", "r@2", "r@latest"):
        assert reg.resolve(ref).version == ref_db.models.resolve(ref).version
    assert reg["r@latest"] is reg.resolve("r@3").pipeline
    want, got = ref_db.models.snapshot()["r"], reg.snapshot()["r"]
    assert sorted(got) == sorted(want) and got["live"] == want["live"] == 1
    assert [(v["version"], v["state"], v["history"]) for v in got["versions"]] == [
        (v["version"], v["state"], v["history"]) for v in want["versions"]]
    for bad, err in (("r@9", "UnknownModelVersionError"), ("r@x", "UnknownModelVersionError"),
                     ("zz", "UnknownModelError")):
        with pytest.raises(terrors.RavenError) as e:
            reg.resolve(bad)
        assert type(e.value).__name__ == err
    assert db.cache_stats()["models"]["r"]["live"] == 1
    assert {"hits", "misses", "evictions"} <= set(db.cache_stats())


# ---------------------------------------------------------------------------
# The paths of ROADMAP items 7, 8 and 9, ported: each works as the
# reference's does
# ---------------------------------------------------------------------------


class _Always:
    """A runtime-selection strategy that picks one runtime whatever the
    pipeline's statistics (``choose`` is the strategies' interface)."""

    def __init__(self, transform: str):
        self.transform = transform

    def choose(self, stats) -> str:
        assert stats.shape == (22,)
        return self.transform


def _verified(prep, _db):
    """``prepare(verify=True)`` (ROADMAP item 8, ported) checks the plan."""
    assert prep.report.verification[-1] == "prepare (stage graph): ok"


def _chosen(prep, _db):
    """``prepare(strategy=...)`` (ROADMAP item 9, ported) runs the strategy's
    runtime."""
    assert prep.report.transforms == {0: "none"}
    assert [s.kind for s in prep.compiled.stages] == ["pure", "host", "pure"]


def _pkg(db):
    return jraven if isinstance(db, jraven.Session) else raven


def _route(db, name: str) -> dict:
    """The route's state the two packages share (not its latency
    percentile, nor the port's graph counts)."""
    snap = db.server.route_snapshot(name)
    keep = ("warmed", "traces", "degraded", "breaker_failures", "breaker_trips",
            "groups", "requests", "rows", "errors")
    return {"live": snap["live"], "shadow": snap["shadow"], "cutovers": snap["cutovers"],
            "ladder": snap["ladder"],
            "versions": {lb: {k: v[k] for k in keep} for lb, v in snap["versions"].items()}}


def _models(db) -> dict:
    return {name: {k: rec[k] for k in ("live", "shadow", "split", "routes")}
            | {"versions": [(v["version"], v["state"]) for v in rec["versions"]]}
            for name, rec in db.models.snapshot().items()}


def _v2_staged(db, prep) -> str:
    """Serve ``prep``, answer one request, publish ``covid_risk`` v2 (the
    same pipeline again) warmed onto the route; returns the serve name."""
    name = prep.serve().name
    prep.submit(_QUICK_BATCH)
    db.flush()
    db.models.publish("covid_risk", db.models.resolve("covid_risk@1").pipeline,
                      warm="sync")
    return name


def _served_answer(db, prep) -> dict:
    req = prep.submit(_QUICK_BATCH)
    db.flush()
    return {"served_by": req.served_by, **_values(req.wait(timeout=60.0))}


def _breaker(db, prep):
    name = prep.serve(options=_pkg(db).ServeOptions(breaker_threshold=2)).name
    return db.server.queries[name].breaker_threshold, _route(db, name)


def _warm(db, prep):
    name = prep.serve().name
    req = prep.submit(_QUICK_BATCH)
    db.flush()
    return db.server.warm_version(name, "v1"), _route(db, name), _values(req.result)


def _server_cutover(db, prep):
    name = _v2_staged(db, prep)
    db.server.cutover(name, "v2")
    return _route(db, name), _served_answer(db, prep)


def _server_shadow(db, prep):
    name = _v2_staged(db, prep)
    db.server.set_shadow(name, "v2")
    return _route(db, name)["shadow"], _served_answer(db, prep)


def _recover(db, prep):
    try:
        db.recover()
    except Exception as e:  # noqa: BLE001 — the typed error is compared
        return type(e).__name__, str(e)
    raise AssertionError("recover() without an artifact store did not raise")


def _shadow(db, prep):
    name = _v2_staged(db, prep)
    db.models.shadow("covid_risk", 2)
    return _models(db), _route(db, name)["shadow"]


def _cutover(db, prep):
    name = _v2_staged(db, prep)
    mv = db.models.cutover("covid_risk", 2)
    return mv.state, _models(db), _served_answer(db, prep), _route(db, name)["cutovers"]


def _at_shadow(db, prep):
    _v2_staged(db, prep)
    db.models.shadow("covid_risk", 2)
    q = db.sql(QUICKSTART.replace("'covid_risk'", "'covid_risk@shadow'"))
    return _values(q.prepare(transform="dnn", params={"threshold": 0.5})())


_QUICK_BATCH = make_hospital(300, seed=9).tables["patients"]
_ONE_STALL = {"delay_ms": 1.0, "times": 1}  # a latency fault: stalls one stage call

# the calls of item 7 (persistence and lifecycle) run on both sessions and
# must come out the same; those of items 8 and 9 hold a check of the feature
LIFECYCLE = object()
NOT_PORTED = {
    "serve": (_breaker, LIFECYCLE),
    "submit": (_warm, LIFECYCLE),
    "flush": (_server_cutover, LIFECYCLE),
    "server": (_server_shadow, LIFECYCLE),
    "recover": (_recover, LIFECYCLE),
    "shadow": (_shadow, LIFECYCLE),
    "cutover": (_cutover, LIFECYCLE),
    "name@shadow": (_at_shadow, LIFECYCLE),
    "prepare verify": (lambda db, prep: prep.query.prepare(
        transform="dnn", params={"threshold": 0.5}, verify=True), _verified),
    "prepare strategy": (lambda db, prep: prep.query.prepare(
        strategy=_Always("none"), params={"threshold": 0.5}), _chosen),
}


def _same(got, want):
    """Equal outcomes: structures exactly, float arrays within rtol 1e-5
    (the port sums the trees in another order)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray) and want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    elif isinstance(want, np.ndarray):
        assert np.array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("what", sorted(NOT_PORTED))
def test_unported_session_paths_raise_naming_their_item(sessions, what):
    """The paths of item 7 (serving with a breaker, the server's version
    verbs, the registry's shadow and cutover, ``name@shadow``,
    ``recover``) run on both sessions with the same outcome; those of items
    8 and 9 work, and their check runs. None raises NotImplementedError."""
    ref_db, db = sessions
    call, check = NOT_PORTED[what]
    if check is LIFECYCLE:  # each package counts only this scenario's work
        jengine.clear_plan_cache()
        teng.clear_plan_cache()
    prep = db.sql(QUICKSTART).prepare(transform="dnn", params={"threshold": 0.5})
    if check is not LIFECYCLE:
        check(call(db, prep), db)
        return
    ref_prep = ref_db.sql(QUICKSTART).prepare(transform="dnn", params={"threshold": 0.5})
    _same(call(db, prep), call(ref_db, ref_prep))


@pytest.mark.parametrize("kwargs,item", [
    ({"cache_dir": "x"}, "item 7"),
    ({"cache_max_bytes": 1 << 20}, "item 7"),
    ({"options": ConnectOptions(cache_dir="x")}, "item 7"),
    ({"options": ConnectOptions(faults=FaultPlan({"latency": _ONE_STALL}, seed=0))}, "item 7"),
    ({"verify": "strict"}, "item 8"),
    ({"options": ConnectOptions(verify=True)}, "item 8"),
    ({"strategy": _Always("sql")}, "item 9"),
])
def test_unported_connect_options_raise_naming_their_item(quickstart, tmp_path, kwargs, item):
    """Every session knob opens a session that applies it, as the
    reference's does: the knobs of item 7 (``cache_dir``, under
    ``tmp_path``, installs an artifact store that persists the prepared
    plan; ``cache_max_bytes`` alone installs none; ``faults`` installs the
    plan until ``close``), of item 8 (``verify``) and of item 9
    (``strategy``) on every prepared query."""
    ds, ref_pipe, port_pipe, score = quickstart
    if "cache_dir" in kwargs:
        kwargs = {"cache_dir": str(tmp_path / kwargs["cache_dir"])}
    elif "options" in kwargs and kwargs["options"].cache_dir is not None:
        kwargs = {"options": ConnectOptions(cache_dir=str(tmp_path / "x"))}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # the legacy keywords
        db = raven.connect(ds.tables, device="cpu", **kwargs)
        ref_kwargs = dict(kwargs)
        if isinstance(kwargs.get("options"), ConnectOptions) and item == "item 7":
            ref_kwargs["options"] = jraven.ConnectOptions(
                cache_dir=kwargs["options"].cache_dir and str(tmp_path / "ref"),
                faults=kwargs["options"].faults and jfaults.FaultPlan(
                    {"latency": _ONE_STALL}, seed=0))
        elif "cache_dir" in kwargs:
            ref_kwargs["cache_dir"] = str(tmp_path / "ref")
        ref_db = jraven.connect(ds.tables, **ref_kwargs) if item == "item 7" else None
    db.register_model("covid_risk", port_pipe)
    t = _gap_thresholds(score[ds.tables["patients"]["asthma"] == 1], (0.5,))[0]
    prep = db.sql(QUICKSTART).prepare(params={"threshold": t})
    if item == "item 7":
        ref_db.register_model("covid_risk", ref_pipe)
        ref_prep = ref_db.sql(QUICKSTART).prepare(params={"threshold": t})
        _assert_agg_close(prep(), ref_prep())
        has_store = db.artifact_store is not None
        wants_store = db.connect_options.cache_dir is not None
        assert has_store == (ref_db.artifact_store is not None) == wants_store
        if has_store:
            assert teng.get_artifact_store() is db.artifact_store
            assert (db.cache_stats()["artifact_store"]["plan_saves"]
                    == ref_db.cache_stats()["artifact_store"]["plan_saves"] == 1)
        faults = db.connect_options.faults
        assert (faults is None) == (ref_db.connect_options.faults is None)
        assert faults is None or faults.injected() == ref_db.connect_options.faults.injected()
        ref_db.close()
        db.close()
        assert teng.get_artifact_store() is None and get_fault_plan() is None
        return
    if item == "item 8":
        assert prep.report.transforms == {0: "none"}
        assert prep.report.verification[0] == "input: ok"
        assert prep.report.verification[-1] == "prepare (stage graph): ok"
    else:
        assert prep.report.transforms == {0: "sql"}
    assert prep()["count_rows"][0] > 0
    db.close()


def test_connect_without_a_card_raises_unless_the_cpu_is_asked_for(quickstart, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        raven.connect(quickstart[0].tables)
    assert raven.connect(quickstart[0].tables, device="cpu").device.type == "cpu"
