"""Runtime selection in the port (``repro_torch.core.{stats,strategies,
corpus}``) against the reference's ``repro.core`` on the same inputs.

``stats.py`` and ``strategies.py`` are numpy copies: on the same pipelines
and arrays both packages give equal statistics (float64, exactly), equal
choices, equal rendered rules and equal evaluations. The corpus's sampler
and trainer are copies too, and the port's ``_measure`` makes the
reference's random draws in the reference's order, so ``build_corpus`` with
one seed trains the reference's pipelines one by one (equal statistics show
it); its times are the port's own, on its device (the CPU here). The
strategy is wired into ``RavenOptimizer``, ``connect(strategy=)`` and
``prepare(strategy=)`` as in the reference: with no transform forced, the
same fitted strategy picks the same runtime for the quickstart query in both
packages, and the answers agree (COUNT exactly, AVG within ``rtol=1e-5``).
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest

import jax.numpy as jnp

import repro as jraven
import repro.core.corpus as jcorpus
import repro.relational.engine as jeng
import repro.ml as jml
import repro_torch as raven
import repro_torch.core.corpus as tcorpus
import repro_torch.ml as tml
from repro.core.stats import STAT_NAMES as J_STAT_NAMES
from repro.core.stats import pipeline_stats as j_pipeline_stats
from repro.core import strategies as jstrat
from repro.core.optimizer import RavenOptimizer as JRavenOptimizer
from repro.data.datasets import make_hospital as j_make_hospital
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro_torch.core import strategies as tstrat
from repro_torch.core.optimizer import RavenOptimizer
from repro_torch.core.stats import STAT_NAMES, pipeline_stats
from repro_torch.data.datasets import make_hospital
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.relational import engine as teng
from repro_torch.serve.query_server import PredictionQueryServer

# the reference's conftest estimators (tests/conftest.py ESTIMATORS)
ESTIMATORS = {
    "dt": lambda m: m.DecisionTreeClassifier(max_depth=6),
    "lr": lambda m: m.LogisticRegression(alpha=0.003, n_iter=120),
    "gb": lambda m: m.GradientBoostingClassifier(n_estimators=8, max_depth=3),
    "rf": lambda m: m.RandomForestClassifier(n_estimators=6, max_depth=5),
}
QUICKSTART = """
    SELECT COUNT(*), AVG(score)
    FROM PREDICT(model = 'covid_risk', data = patients) AS p
    WHERE asthma = 1 AND score >= :threshold
"""
STRATEGIES = ("rule", "classification", "regression")
N_STATS = len(STAT_NAMES)


def _fit_strategy(pkg, kind: str, X, labels, runtimes):
    if kind == "rule":
        return pkg.RuleBasedStrategy().fit(X, labels)
    if kind == "classification":
        return pkg.ClassificationStrategy(n_estimators=5).fit(X, labels)
    return pkg.RegressionStrategy().fit(X, runtimes)


def _seeded_corpus(seed: int, n: int = 60, single: int | None = None):
    """Pipeline statistics (n x 22) and runtimes (n x 3) drawn with numpy:
    counts and sizes spread over the corpus's ranges, runtimes that depend
    on them (so the fastest runtime follows the statistics) plus noise.
    ``single`` makes one runtime the fastest everywhere."""
    rng = np.random.default_rng(seed)
    X = np.abs(rng.normal(size=(n, N_STATS))) * rng.choice([1.0, 10.0, 1000.0], N_STATS)
    X[:, 9] = rng.integers(0, 2, n)  # is_tree_model
    X[:, 10] = 1.0 - X[:, 9]  # is_linear_model
    X[:, 11] = np.where(X[:, 9] > 0, rng.integers(1, 120, n), 0)  # n_trees
    runtimes = np.stack([
        1e-3 * (1.0 + X[:, 11]) * (1.0 + rng.uniform(size=n)),
        1e-4 * (1.0 + X[:, 20] / 100.0) * (1.0 + rng.uniform(size=n)),
        2e-3 * (1.0 + rng.uniform(size=n)),
    ], axis=1)
    if single is not None:
        runtimes[:, single] = 1e-6
    return X, runtimes, np.argmin(runtimes, axis=1)


# ---------------------------------------------------------------------------
# Pipeline statistics
# ---------------------------------------------------------------------------


def test_stat_names_are_the_reference_s():
    assert STAT_NAMES == J_STAT_NAMES and N_STATS == 22


@pytest.mark.parametrize("kind", sorted(ESTIMATORS))
def test_pipeline_stats_equal_the_reference_on_conftest_pipelines(kind):
    """The dt/lr/gb/rf pipelines built as tests/conftest.py builds them,
    trained by each package's own trainer."""
    mine_ds, theirs_ds = make_hospital(2048, seed=1), j_make_hospital(2048, seed=1)
    mine = tml.fit_pipeline(
        mine_ds.joined_columns(), mine_ds.label, mine_ds.numeric, mine_ds.categorical,
        ESTIMATORS[kind](tml), categories=mine_ds.categories(),
    )
    theirs = jml.fit_pipeline(
        theirs_ds.joined_columns(), theirs_ds.label, theirs_ds.numeric,
        theirs_ds.categorical, ESTIMATORS[kind](jml), categories=theirs_ds.categories(),
    )
    got, want = pipeline_stats(mine), j_pipeline_stats(theirs)
    assert got.dtype == want.dtype == np.float64 and got.shape == (N_STATS,)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [1, 8])
def test_pipeline_stats_equal_on_sampled_pipelines(seed):
    """``_sample_pipeline_spec`` + ``_train_one`` from one seed in both
    packages: the same specs, the same statistics."""
    mine_rng, theirs_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        spec = tcorpus._sample_pipeline_spec(mine_rng)
        jspec = jcorpus._sample_pipeline_spec(theirs_rng)
        assert {k: np.asarray(v).tolist() for k, v in spec.items()} == {
            k: np.asarray(v).tolist() for k, v in jspec.items()}
        got = pipeline_stats(tcorpus._train_one(spec, mine_rng, n_rows=256))
        want = j_pipeline_stats(jcorpus._train_one(jspec, theirs_rng, n_rows=256))
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# The three strategies on the same arrays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("single", [None, 0, 2], ids=["mixed", "all-none", "all-dnn"])
@pytest.mark.parametrize("kind", STRATEGIES)
def test_strategies_choose_as_the_reference(kind, single):
    X, runtimes, labels = _seeded_corpus(3, single=single)
    if single is not None:
        assert set(labels) == {single}
    mine = _fit_strategy(tstrat, kind, X, labels, runtimes)
    theirs = _fit_strategy(jstrat, kind, X, labels, runtimes)
    # every training row, and rows of another draw
    X2, runtimes2, labels2 = _seeded_corpus(4)
    for row in np.concatenate([X, X2]):
        assert mine.choose(row) == theirs.choose(row)
    for Xe, le, re in ((X, labels, runtimes), (X2, labels2, runtimes2)):
        assert tstrat.evaluate_strategy(mine, Xe, le, re) == jstrat.evaluate_strategy(
            theirs, Xe, le, re)
    if kind == "rule":
        assert mine.describe() == theirs.describe()
        assert np.array_equal(mine.top_features, theirs.top_features)
    if single is not None:
        assert {mine.choose(r) for r in X2} == {tstrat.TRANSFORMS[single]}


def test_multiclass_tree_probabilities_equal_the_reference():
    X, _, labels = _seeded_corpus(5)
    mine = tstrat.MulticlassTreeClassifier(max_depth=4, max_features=5, seed=3).fit(X, labels)
    theirs = jstrat.MulticlassTreeClassifier(max_depth=4, max_features=5, seed=3).fit(X, labels)
    assert np.array_equal(mine.importances_, theirs.importances_)
    assert np.array_equal(mine.predict_proba(X), theirs.predict_proba(X))
    assert np.array_equal(mine.predict(X), theirs.predict(X))


# ---------------------------------------------------------------------------
# The port's corpus, measured on the CPU
# ---------------------------------------------------------------------------


def _draws_only(pipe, n_rows, rng, repeats=2):
    """The reference's ``_measure`` with its timing left out: the same
    draws from ``rng``, in the same order, and no runtime."""
    for s in pipe.inputs:
        if s.kind == "numeric":
            rng.normal(size=n_rows)
        else:
            rng.integers(0, 4, n_rows)
    return np.zeros(3)


def test_port_corpus_trains_the_reference_pipelines(monkeypatch):
    """The rng-order test: three pipelines of seed 1 (a random forest, a
    gradient-boosting model and a logistic regression), measured by the
    port on the CPU at 256 rows, against the reference's pipelines of the
    same seed (its ``_measure`` replaced by one that makes the same draws)."""
    corpus = tcorpus.build_corpus(n_pipelines=3, n_rows=256, seed=1, device="cpu")
    monkeypatch.setattr(jcorpus, "_measure", _draws_only)
    ref = jcorpus.build_corpus(n_pipelines=3, n_rows=256, seed=1)
    assert corpus.stats.shape == (3, N_STATS) and corpus.runtimes.shape == (3, 3)
    assert np.array_equal(corpus.stats, ref.stats)
    assert np.array_equal(corpus.stats, np.stack([j_pipeline_stats(p) for p in ref.pipelines]))
    assert np.isfinite(corpus.runtimes[:, [0, 2]]).all() and (corpus.runtimes > 0).all()
    assert np.array_equal(corpus.labels, np.argmin(corpus.runtimes, axis=1))
    assert [p.model_nodes()[0].op for p in corpus.pipelines] == [
        "tree_ensemble", "tree_ensemble", "linear"]


def test_corpus_leaves_the_plan_cache_as_it_was(monkeypatch):
    """A corpus's measurement plans stay out of the compiled-plan cache: a
    plan compiled before it is still cached after it, even with the cache
    one entry from full, and nothing was evicted."""
    plan = teng.Project(teng.Scan("batch", ["a"]), ["a"])
    compiled = teng.compile_plan(plan)
    monkeypatch.setattr(teng, "PLAN_CACHE_CAPACITY", len(teng._PLAN_CACHE) + 1)
    cached, evicted = list(teng._PLAN_CACHE), teng.PLAN_CACHE_STATS.evictions
    tcorpus.build_corpus(n_pipelines=2, n_rows=64, seed=3, device="cpu")
    assert list(teng._PLAN_CACHE) == cached
    assert teng.PLAN_CACHE_STATS.evictions == evicted
    assert teng.compile_plan(plan) is compiled


# ---------------------------------------------------------------------------
# Wiring: RavenOptimizer, connect(strategy=) and prepare(strategy=)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    """The quickstart's data and pipeline, trained by the reference and
    carried over through its save format."""
    ds = j_make_hospital(2000, seed=0)
    ref_pipe = jml.fit_pipeline(
        ds.joined_columns(), ds.label, ds.numeric, ds.categorical,
        jml.GradientBoostingClassifier(n_estimators=12, max_depth=3),
        categories=ds.categories(),
    )
    path = str(tmp_path_factory.mktemp("m") / "gb.npz")
    ref_save_pipeline(ref_pipe, path)
    port_pipe = load_pipeline(path)
    cols = ds.joined_columns()
    score = np.asarray(jml.run_pipeline(ref_pipe, cols)[ref_pipe.outputs[0]]).reshape(-1)
    s = np.unique(score[ds.tables["patients"]["asthma"] == 1].astype(np.float64))
    i = len(s) // 2 + int(np.argmax(np.diff(s[len(s) // 2:][:201])))
    assert s[i + 1] - s[i] >= 2e-5
    t = float(np.float32((s[i] + s[i + 1]) / 2))
    return ds, ref_pipe, port_pipe, t


def _fitted_pair(kind: str, label: str | None):
    """One strategy of ``kind`` fitted on the same arrays in both packages:
    with ``label`` every row's fastest runtime is that one, else a mixed
    corpus."""
    single = None if label is None else tstrat.TRANSFORMS.index(label)
    X, runtimes, labels = _seeded_corpus(6, single=single)
    return (_fit_strategy(tstrat, kind, X, labels, runtimes),
            _fit_strategy(jstrat, kind, X, labels, runtimes))


def _prepared(via: str, pkg, tables, pipe, strategy, t):
    """The quickstart query prepared with ``strategy`` through ``via``:
    returns the session, the optimizer's report and a call running it."""
    kw = {"device": "cpu"} if pkg is raven else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        db = pkg.connect(tables, stats="auto",
                         strategy=strategy if via == "connect" else None, **kw)
    db.register_model("covid_risk", pipe)
    q = db.sql(QUICKSTART)
    if via != "optimizer":
        prep = q.prepare(strategy=strategy if via == "prepare" else None,
                         params={"threshold": t})
        return db, prep.report, prep
    params = {"threshold": t}
    if pkg is raven:
        plan, report = RavenOptimizer(strategy=strategy).optimize(q.ir)
        compiled = teng.compile_plan(plan)
        return db, report, lambda: compiled.run(
            tables, params=params, device="cpu").table.to_numpy()
    plan, report = JRavenOptimizer(strategy=strategy).optimize(q.ir)
    compiled = jeng.compile_plan(plan)
    jtables = {k: {c: jnp.asarray(v) for c, v in cols.items()} for k, cols in tables.items()}
    return db, report, lambda: compiled(jtables, params=params).to_numpy()


@pytest.mark.parametrize("label", ["none", "sql", "dnn", None],
                         ids=["none", "sql", "dnn", "mixed"])
@pytest.mark.parametrize("via", ["optimizer", "connect", "prepare"])
def test_strategy_picks_the_reference_s_runtime(quickstart, via, label):
    ds, ref_pipe, port_pipe, t = quickstart
    mine_s, theirs_s = _fitted_pair("rule" if label is not None else "classification", label)
    assert pipeline_stats(port_pipe).tolist() == j_pipeline_stats(ref_pipe).tolist()
    db, report, run = _prepared(via, raven, ds.tables, port_pipe, mine_s, t)
    ref_db, ref_report, ref_run = _prepared(via, jraven, ds.tables, ref_pipe, theirs_s, t)
    got, want = run(), ref_run()
    chosen = mine_s.choose(pipeline_stats(port_pipe))
    assert report.transforms == ref_report.transforms == {0: chosen}
    if label is not None:
        assert chosen == label
    assert got["count_rows"][0] > 0
    assert np.array_equal(got["count_rows"], want["count_rows"])
    np.testing.assert_allclose(got["mean_score"], want["mean_score"], rtol=1e-5)
    db.close()
    ref_db.close()


def test_forced_transform_overrides_the_strategy(quickstart):
    ds, _, port_pipe, t = quickstart
    mine_s, _ = _fitted_pair("rule", "sql")
    db = raven.connect(ds.tables, stats="auto", device="cpu", strategy=mine_s)
    db.register_model("covid_risk", port_pipe)
    prep = db.sql(QUICKSTART).prepare(transform="dnn", params={"threshold": t})
    assert prep.report.transforms == {0: "dnn"}
    # the per-query strategy wins over the session's
    other, _ = _fitted_pair("rule", "none")
    prep = db.sql(QUICKSTART).prepare(strategy=other, params={"threshold": t})
    assert prep.report.transforms == {0: "none"}
    db.close()


@pytest.mark.parametrize("label", ["none", "dnn"])
def test_served_query_runs_the_runtime_the_strategy_chose(quickstart, label):
    ds, _, port_pipe, t = quickstart
    mine_s, _ = _fitted_pair("rule", label)
    db = raven.connect(ds.tables, stats="auto", device="cpu", strategy=mine_s)
    db.register_model("covid_risk", port_pipe)
    prep = db.sql(QUICKSTART).prepare(params={"threshold": t})
    prep.serve(name="q")
    reg = db.server.queries["q"]
    assert reg.report.transforms == {0: label}
    kinds = [s.kind for s in reg.compiled.stages]
    assert kinds == (["pure", "host", "pure"] if label == "none" else ["pure"])
    cols = ds.tables["patients"]
    batches = [{c: v[s:s + 300] for c, v in cols.items()} for s in (0, 700)]
    reqs = [prep.submit(b) for b in batches]
    db.flush()
    for r, b in zip(reqs, batches):
        want = prep(b)
        assert np.array_equal(r.result["count_rows"], want["count_rows"])
        np.testing.assert_allclose(r.result["mean_score"], want["mean_score"], rtol=1e-5)
    # a server built with the strategy optimizes with it too
    srv = PredictionQueryServer(strategy=mine_s, device="cpu")
    own = srv.register("own", db.sql(QUICKSTART).ir, ds.tables,
                       params={"threshold": t})
    assert own.report.transforms == {0: label}
    srv.shutdown()
    db.close()
