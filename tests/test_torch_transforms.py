"""MLtoSQL in the port against the reference package, on the CPU.

The port's ``compile_pipeline_to_sql`` is a copy of the reference's: the
same pipeline gives the same expression tree (the same node count, score
space and content fingerprint). The port's ``eval_expr`` evaluates it with
torch: bitwise equal to the reference's ``eval_expr`` in float32 where no
``sigmoid`` is involved, and within 2 float32 ulps where one is (torch's
``exp`` and XLA's differ in the last bit). Through the front door
(``repro_torch.connect(..., device="cpu")``) ``transform="sql"`` queries
(logit-space thresholds, probability-space scores, partitioned models, a
join) give the reference's COUNT exactly and its AVG within ``rtol=1e-5``,
and an l2 normalizer falls back to the interpreted runtime as in the
reference. Pipelines are trained by the reference and carried over through
its save format.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro as jraven
import repro.ml as jml
import repro_torch as raven
from repro.core.fingerprint import fingerprint as ref_fingerprint
from repro.core.rules.ml_to_sql import compile_pipeline_to_sql as ref_to_sql
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.relational.expr import Un as RefUn
from repro.relational.expr import eval_expr as ref_eval
from repro_torch.core.fingerprint import fingerprint
from repro_torch.core.optimizer import format_physical_plan
from repro_torch.core.rules.ml_to_sql import MLtoSQLUnsupported, compile_pipeline_to_sql
from repro_torch.ml.pipeline import (
    InputSpec,
    PipelineNode,
    TrainedPipeline,
    load_pipeline,
    run_pipeline,
)
from repro_torch.relational import engine as teng
from repro_torch.relational.expr import Case, Un, eval_expr
from tests.conftest import train_pipeline

KINDS = ["dt", "gb", "lr", "rf"]
COUNT_AVG = ("SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) AS p "
             "WHERE score >= :t")
COUNT_ONLY = ("SELECT COUNT(*) FROM PREDICT(model='m', data=patients) AS p "
              "WHERE score >= :t")


def _gap_thresholds(scores, quantiles, min_gap: float = 2e-5):
    """Bindings mid-way in the widest gap between consecutive scores near
    each quantile, so last-bit differences move no row across them."""
    s = np.unique(np.asarray(scores, np.float64))
    out = []
    for q in quantiles:
        i = int(q * (len(s) - 2))
        j = i + int(np.argmax(np.diff(s[i : i + 201])))
        assert s[j + 1] - s[j] >= min_gap
        out.append(float(np.float32((s[j] + s[j + 1]) / 2)))
    return out


@pytest.fixture(scope="module")
def pipes(hospital, tmp_path_factory):
    """Each estimator's hospital pipeline, trained by the reference and
    carried over to the port: kind -> (reference pipeline, port pipeline)."""
    out = {}
    for kind in KINDS:
        ref_pipe = train_pipeline(hospital, kind)
        path = str(tmp_path_factory.mktemp("m") / f"{kind}.npz")
        ref_save_pipeline(ref_pipe, path)
        out[kind] = (ref_pipe, load_pipeline(path))
    return out


def _sessions(tables, ref_pipe, port_pipe, **kw):
    ref_db = jraven.connect(tables, **kw)
    ref_db.register_model("m", ref_pipe)
    db = raven.connect(tables, device="cpu", **kw)
    db.register_model("m", port_pipe)
    return ref_db, db


def _assert_same_answer(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    assert got["count_rows"][0] > 0
    assert np.array_equal(got["count_rows"], np.asarray(want["count_rows"]))
    if "mean_score" in want:
        np.testing.assert_allclose(got["mean_score"], np.asarray(want["mean_score"]),
                                   rtol=1e-5)


def _host_scores(pipe, tables) -> np.ndarray:
    cols = tables["patients"]
    return np.asarray(run_pipeline(pipe, {n: cols[n] for n in pipe.input_names()})
                      [pipe.outputs[0]]).reshape(-1)


# ---------------------------------------------------------------------------
# The compiled expressions and their evaluation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_mltosql_expression_tree_matches_reference(pipes, kind):
    ref_pipe, port_pipe = pipes[kind]
    want, got = ref_to_sql(ref_pipe), compile_pipeline_to_sql(port_pipe)
    assert got.size == want.size > 0
    assert got.score_space == want.score_space
    assert sorted(got.exprs) == sorted(want.exprs)
    for o in want.exprs:  # the same content hash: the same tree, node for node
        assert fingerprint(got.exprs[o]) == ref_fingerprint(want.exprs[o])


@pytest.mark.parametrize("kind", KINDS)
def test_mltosql_eval_matches_reference(hospital, pipes, kind):
    ref_pipe, port_pipe = pipes[kind]
    want, got = ref_to_sql(ref_pipe), compile_pipeline_to_sql(port_pipe)
    joined = hospital.joined_columns()
    # the engine's inputs: 64-bit columns demoted as the upload demotes them
    ref_env = {n: jnp.asarray(joined[n]) for n in ref_pipe.input_names()}
    env = {n: torch.from_numpy(np.array(ref_env[n])) for n in ref_pipe.input_names()}
    for o in want.exprs:  # no sigmoid: bitwise, dtype included
        a = np.asarray(ref_eval(want.exprs[o], ref_env))
        b = eval_expr(got.exprs[o], env).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint32) if a.dtype == np.float32 else a,
                              b.view(np.uint32) if b.dtype == np.float32 else b), o
    # the probability-space score: torch's exp against XLA's, 2 ulps
    a = np.asarray(ref_eval(RefUn("sigmoid", want.exprs["score"]), ref_env))
    b = eval_expr(Un("sigmoid", got.exprs["score"]), env).numpy()
    assert a.dtype == b.dtype == np.float32
    assert np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max() <= 2


@pytest.mark.parametrize("kind", KINDS)
def test_mltosql_labels_match_the_host_interpreter(hospital, pipes, kind):
    """The reference test's bound: under 0.8% of labels flip (float32
    thresholds against the interpreter's float64)."""
    _, port_pipe = pipes[kind]
    comp = compile_pipeline_to_sql(port_pipe)
    joined = hospital.joined_columns()
    env = {n: torch.from_numpy(np.asarray(joined[n], np.float32))
           for n in port_pipe.input_names()}
    host = run_pipeline(port_pipe, {n: joined[n] for n in port_pipe.input_names()})
    got = eval_expr(comp.exprs["label"], env).numpy()
    assert (got == np.asarray(host["label"]).reshape(-1)).mean() > 0.992


def test_eval_expr_drops_intermediates_and_keeps_constants(pipes):
    """Freeing each value after its last consumer and caching constants
    change no bit; the cache holds one tensor per constant node and device,
    and a second call creates none."""
    _, port_pipe = pipes["gb"]
    expr = compile_pipeline_to_sql(port_pipe).exprs["score"]
    rng = np.random.default_rng(0)
    env = {n: torch.from_numpy(rng.integers(0, 3, 64).astype(np.float32))
           for n in port_pipe.input_names()}
    plain = eval_expr(expr, env)
    consts: dict = {}
    first = eval_expr(expr, env, consts=consts)
    n = len(consts)
    again = eval_expr(expr, env, consts=consts)
    assert n > 0 and len(consts) == n
    assert torch.equal(plain, first) and torch.equal(first, again)
    # a value shared by two consumers survives the first of them
    from repro_torch.relational.expr import Bin, Col

    x = Col(port_pipe.input_names()[0])
    shared = Bin("mul", x, x)
    e = Bin("add", Bin("add", shared, shared), shared)
    assert torch.equal(eval_expr(e, env), 3 * env[x.name] * env[x.name])


# ---------------------------------------------------------------------------
# Through the front door
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("threshold", ["param", "const"])
def test_logit_space_thresholds_match_probability_space(hospital, pipes, threshold):
    """A score seen only by threshold filters stays in logit space and the
    thresholds move (``logit(:t)`` or a logit constant); a score the query
    returns is emitted in probability space. Both count the same rows, as
    the reference does."""
    ref_pipe, port_pipe = pipes["gb"]
    ref_db, db = _sessions(hospital.tables, ref_pipe, port_pipe)
    (t,) = _gap_thresholds(_host_scores(port_pipe, hospital.tables), (0.6,))
    if threshold == "param":
        texts, params = (COUNT_ONLY, COUNT_AVG), {"t": t}
    else:
        texts = tuple(q.replace(":t", repr(t)) for q in (COUNT_ONLY, COUNT_AVG))
        params = None
    counts = []
    for text, space in zip(texts, ("logit", "probability")):
        prep = db.sql(text).prepare(transform="sql", params=params)
        ref_prep = ref_db.sql(text).prepare(transform="sql", params=params)
        assert any(f"emitted in {space} space" in n for n in prep.report.notes)
        assert prep.report.notes == ref_prep.report.notes
        assert prep.report.stages == ref_prep.report.stages
        got, want = prep(), ref_prep()
        _assert_same_answer(got, want)
        counts.append(got["count_rows"][0])
        filt = [p for p in teng.walk_plan(prep.plan) if isinstance(p, teng.Filter)]
        text_filter = format_physical_plan(filt[0]).splitlines()[0]
        assert ("logit(:t)" in text_filter) == (space == "logit" and params is not None)
    assert counts[0] == counts[1] == (_host_scores(port_pipe, hospital.tables) >= t).sum()


def test_partitioned_mltosql_matches_reference(hospital, pipes):
    """Data-induced specialisation over a partition column: one model per
    partition, chosen by a CASE over the column."""
    ref_pipe, port_pipe = pipes["dt"]
    kw = {"stats": "auto", "partition_cols": {"patients": "rcount"}}
    ref_db, db = _sessions(hospital.tables, ref_pipe, port_pipe, **kw)
    (t,) = _gap_thresholds(_host_scores(port_pipe, hospital.tables), (0.5,))
    prep = db.sql(COUNT_AVG).prepare(transform="sql", params={"t": t})
    ref_prep = ref_db.sql(COUNT_AVG).prepare(transform="sql", params={"t": t})
    assert any("MLtoSQL partitioned over rcount (6 specialized models)" in n
               for n in prep.report.notes)
    proj = next(p for p in teng.walk_plan(prep.plan) if isinstance(p, teng.Project))
    assert isinstance(proj.exprs["score"], Case)
    _assert_same_answer(prep(), ref_prep())


def _l2_pipeline() -> TrainedPipeline:
    """A pipeline with an l2 normalizer, which MLtoSQL does not translate."""
    return TrainedPipeline(
        inputs=[InputSpec("a", "numeric"), InputSpec("b", "numeric")],
        outputs=["score", "label"],
        nodes=[
            PipelineNode("concat", ["a", "b"], ["raw"], {}),
            PipelineNode("normalizer", ["raw"], ["norm"], {"norm": "l2"}),
            PipelineNode(
                "linear", ["norm"], ["score", "label"],
                {"weights": np.asarray([1.0, -1.0]), "bias": 0.0, "post": "logistic"},
            ),
        ],
    )


def test_sql_falls_back_to_none_on_an_l2_normalizer():
    from repro.core.ir import LPredict as RefLPredict
    from repro.ml.pipeline import InputSpec as RI
    from repro.ml.pipeline import PipelineNode as RN
    from repro.ml.pipeline import TrainedPipeline as RT
    from repro.core.ir import LScan as RefLScan
    from repro.core.ir import PredictionQuery as RefQuery
    from repro.core.optimizer import OptimizerOptions as RefOptions
    from repro.core.optimizer import RavenOptimizer as RefOptimizer
    from repro.relational.engine import execute_plan as ref_execute
    from repro_torch.core.ir import LPredict, LScan, PredictionQuery
    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer

    with pytest.raises(MLtoSQLUnsupported):
        compile_pipeline_to_sql(_l2_pipeline())
    rng = np.random.default_rng(0)
    db = {"t": {"a": rng.normal(size=64), "b": rng.normal(size=64)}}
    q = PredictionQuery(plan=LPredict(LScan("t", ["a", "b"]), _l2_pipeline(),
                                      ["score", "pred"]))
    plan, report = RavenOptimizer(options=OptimizerOptions(transform="sql")).optimize(q)
    assert any(isinstance(p, teng.MLUdf) for p in teng.walk_plan(plan))
    assert any("MLtoSQL fallback" in n for n in report.notes)
    assert report.placement == [[("concat[raw]", "host"), ("normalizer[norm]", "host"),
                                 ("linear[score, label]", "host")]]
    out = teng.execute_plan(plan, db, device="cpu").to_numpy()
    host = run_pipeline(_l2_pipeline(), db["t"])
    np.testing.assert_allclose(out["score"], np.asarray(host["score"]).reshape(-1),
                               rtol=1e-5)
    ref_pipe = RT(inputs=[RI(s.name, s.kind) for s in _l2_pipeline().inputs],
                  outputs=["score", "label"],
                  nodes=[RN(n.op, n.inputs, n.outputs, n.attrs) for n in _l2_pipeline().nodes])
    ref_plan, ref_report = RefOptimizer(options=RefOptions(transform="sql")).optimize(
        RefQuery(plan=RefLPredict(RefLScan("t", ["a", "b"]), ref_pipe, ["score", "pred"])))
    assert report.stages == ref_report.stages
    assert report.notes[0] == ref_report.notes[0]  # the fallback's reason
    want = ref_execute(ref_plan, db).to_numpy()
    assert sorted(out) == sorted(want)
    for k in want:  # the same interpreter, the same upload: the same bits
        assert out[k].dtype == np.asarray(want[k]).dtype
        assert np.array_equal(out[k], np.asarray(want[k]))


def test_sql_fallback_keeps_hidden_score_thresholds_in_probability_space():
    """The score feeds only a threshold, which MLtoSQL would move to logit
    space; the l2 normalizer sends the pipeline to the host MLUdf instead,
    whose scores are probabilities, so the threshold stays as written and
    COUNT is the host interpreter's. (The reference moves the threshold
    before its fallback and counts wrong here.)"""
    rng = np.random.default_rng(0)
    tables = {"t": {"a": rng.normal(size=64), "b": rng.normal(size=64)}}
    host = np.asarray(run_pipeline(_l2_pipeline(), tables["t"])["score"]).reshape(-1)
    db = raven.connect(tables, device="cpu")
    db.register_model("m", _l2_pipeline())
    text = "SELECT COUNT(*) FROM PREDICT(model='m', data=t) AS p WHERE score >= :t"
    prep = db.sql(text).prepare(transform="sql", params={"t": 0.5})
    assert prep.report.notes[0] == "MLtoSQL fallback: l2 normalizer needs sqrt"
    assert any(isinstance(p, teng.MLUdf) for p in teng.walk_plan(prep.plan))
    filt = next(p for p in teng.walk_plan(prep.plan) if isinstance(p, teng.Filter))
    assert "logit" not in format_physical_plan(filt)
    for t in (0.3, 0.5, 0.7):
        got = prep.bind(t=t)()["count_rows"]
        assert got.tolist() == [float((host >= t).sum())]
        assert 0 < got[0] < len(host)


def test_sql_join_query_matches_reference(expedia, tmp_path):
    """MLtoSQL over a star schema: the model's CASE expressions read the
    joined dimension columns (the Join steps run before the Project of the
    compiled expressions, and the filter and aggregate after it)."""
    ref_pipe = jml.fit_pipeline(
        expedia.joined_columns(), expedia.label, expedia.numeric, expedia.categorical,
        jml.GradientBoostingClassifier(n_estimators=8, max_depth=3),
        categories=expedia.categories(),
    )
    path = str(tmp_path / "gb.npz")
    ref_save_pipeline(ref_pipe, path)
    ref_db, db = _sessions(expedia.tables, ref_pipe, load_pipeline(path), stats="auto")
    cols = expedia.joined_columns()
    score = np.asarray(jml.run_pipeline(ref_pipe, cols)[ref_pipe.outputs[0]]).reshape(-1)
    (t,) = _gap_thresholds(score, (0.4,), min_gap=1e-5)
    text = ("SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=searches "
            "JOIN hotels ON hotel_id = hotel_id "
            "JOIN destinations ON dest_id = dest_id) AS p WHERE score >= :t")
    prep = db.sql(text).prepare(transform="sql", params={"t": t})
    ref_prep = ref_db.sql(text).prepare(transform="sql", params={"t": t})
    ops = [type(p).__name__ for p in teng.walk_plan(prep.plan)][::-1]
    assert "Join" in ops and ops.index("Join") < ops.index("Project")
    assert prep.report.stages == ref_prep.report.stages
    _assert_same_answer(prep(), ref_prep())
    batch = {c: v[: len(v) // 2] for c, v in expedia.tables["searches"].items()}
    _assert_same_answer(prep(batch), ref_prep(batch))


def test_three_transforms_agree_on_avg_score(hospital, pipes):
    """AVG(score) must see probability-space scores from MLtoSQL: the three
    runtimes agree within 5e-3, as in the reference, and each equals the
    reference's runtime of the same name."""
    ref_pipe, port_pipe = pipes["gb"]
    ref_db, db = _sessions(hospital.tables, ref_pipe, port_pipe)
    text = "SELECT AVG(score) FROM PREDICT(model='m', data=patients) AS p"
    outs = {}
    for t in ("none", "sql", "dnn"):
        got = float(db.sql(text).prepare(transform=t)()["mean_score"][0])
        want = float(np.asarray(ref_db.sql(text).prepare(transform=t)()["mean_score"])[0])
        np.testing.assert_allclose(got, want, rtol=1e-5)
        outs[t] = got
    assert abs(outs["sql"] - outs["none"]) < 5e-3
    assert abs(outs["dnn"] - outs["none"]) < 5e-3
