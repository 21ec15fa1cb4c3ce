"""The port's main path end to end against the reference package.

Two plans make up the slice: the hospital prediction query lowered whole by
MLtoDNN (``Scan→Filter→TensorOp→Filter→Aggregate`` in one pure stage,
reaching ``featurize``, the tree step and ``segment_agg``), and the
filter→join→aggregate dashboard plan (reaching ``gather_join`` and
``segment_agg``). Both run through the engine-level entry points
(``parse_prediction_query`` → ``RavenOptimizer.optimize`` → ``compile_plan``
→ ``CompiledPlan.run``) of each package on the same tables and weights.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ml as jml
from repro.core.optimizer import OptimizerOptions as RefOptions
from repro.core.optimizer import RavenOptimizer as RefOptimizer
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.relational import engine as reng
from repro.sql.parser import parse_prediction_query as ref_parse
from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.relational import engine as teng
from repro_torch.sql.parser import parse_prediction_query

QUERY = (
    "SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) AS p "
    "WHERE asthma = 1 AND score >= :t"
)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _gap_thresholds(scores: np.ndarray, quantiles, min_gap: float = 2e-5):
    """Bindings of ``:t`` near the given quantiles, mid-way in the widest
    gap between consecutive scores among the next 1,000, so that two
    computations of the same score that differ in the last bits cannot
    disagree on ``score >= t``."""
    s = np.unique(np.asarray(scores, np.float64))
    out = []
    for q in quantiles:
        i = int(q * (len(s) - 2))
        j = i + int(np.argmax(np.diff(s[i : i + 1001])))
        assert s[j + 1] - s[j] >= min_gap
        out.append(float(np.float32((s[j] + s[j + 1]) / 2)))
    return out


@pytest.fixture(scope="module")
def hospital_case(tmp_path_factory):
    from repro.data.datasets import make_hospital

    train = make_hospital(1024, seed=0)
    infer = make_hospital(3000, seed=0)
    ref_pipe = jml.fit_pipeline(
        train.joined_columns(), train.label, train.numeric, train.categorical,
        jml.GradientBoostingClassifier(n_estimators=10, max_depth=3),
        categories=train.categories(),
    )
    path = str(tmp_path_factory.mktemp("m") / "gb.npz")
    ref_save_pipeline(ref_pipe, path)
    cols = infer.joined_columns()
    score = jml.run_pipeline(
        ref_pipe, {n: cols[n] for n in ref_pipe.input_names()}
    )[ref_pipe.outputs[0]]
    return ref_pipe, load_pipeline(path), infer, _gap_thresholds(score, (0.3, 0.7))


def test_hospital_query_matches_reference(hospital_case):
    ref_pipe, port_pipe, infer, thresholds = hospital_case
    ref_plan, ref_report = RefOptimizer(options=RefOptions(transform="dnn")).optimize(
        ref_parse(QUERY, {"m": ref_pipe}, infer.tables)
    )
    plan, report = RavenOptimizer(
        options=OptimizerOptions(transform="dnn")
    ).optimize(parse_prediction_query(QUERY, {"m": port_pipe}, infer.tables))
    # one pure stage, the same operator chain as the reference's lowering
    assert report.stages == ref_report.stages
    assert len(report.stages) == 1 and "TensorOp" in report.stages[0]
    ref_cp = reng.compile_plan(ref_plan)
    cp = teng.compile_plan(plan)
    ref_db = {t: {c: jnp.asarray(v) for c, v in cs.items()}
              for t, cs in infer.tables.items()}
    db = teng.upload_database(infer.tables, "cpu")
    for t in thresholds:  # a few requests to one compiled plan
        want = ref_cp.run(ref_db, params={"t": t}).table.to_numpy()
        got = cp.run(db, params={"t": t}, device="cpu").table.to_numpy()
        assert sorted(got) == sorted(want) == ["count_rows", "mean_score"]
        assert got["count_rows"][0] > 0
        assert np.array_equal(got["count_rows"], want["count_rows"])
        np.testing.assert_allclose(got["mean_score"], want["mean_score"], rtol=1e-5)
    assert teng.compile_plan(plan) is cp  # the plan cache holds it


def test_hospital_query_gemm_strategy_matches_reference(hospital_case):
    """The strategy the card takes (GEMM), run here by its plain version."""
    ref_pipe, port_pipe, infer, thresholds = hospital_case
    ref_plan, _ = RefOptimizer(options=RefOptions(transform="dnn")).optimize(
        ref_parse(QUERY, {"m": ref_pipe}, infer.tables)
    )
    plan, _ = RavenOptimizer(options=OptimizerOptions(
        transform="dnn", tensor_strategy="gemm"
    )).optimize(parse_prediction_query(QUERY, {"m": port_pipe}, infer.tables))
    ref_db = {t: {c: jnp.asarray(v) for c, v in cs.items()}
              for t, cs in infer.tables.items()}
    want = reng.compile_plan(ref_plan).run(
        ref_db, params={"t": thresholds[0]}).table.to_numpy()
    got = teng.compile_plan(plan).run(
        infer.tables, params={"t": thresholds[0]}, device="cpu").table.to_numpy()
    assert np.array_equal(got["count_rows"], want["count_rows"])
    np.testing.assert_allclose(got["mean_score"], want["mean_score"], rtol=1e-5)


# ---------------------------------------------------------------------------
# The dashboard plan: filter→join→aggregate over a star schema
# ---------------------------------------------------------------------------


def _dyadic(rng, shape):
    return (rng.integers(-40, 40, size=shape) * 0.25).astype(np.float32)


def _star_tables(n=200, m=16, seed=3):
    """Dyadic values: f32 sums are exact in any order, so every execution
    path must agree bit for bit. Some fact keys miss the dim table."""
    rng = np.random.default_rng(seed)
    dim = {"k": np.arange(m, dtype=np.int64), "v1": _dyadic(rng, m),
           "v2": _dyadic(rng, m)}
    fact = {"fk": rng.integers(0, m + 4, size=n).astype(np.int64),
            "x": _dyadic(rng, n)}
    return {"f": fact, "d": dim}


def _dashboard_plan(pkg):
    from importlib import import_module

    eng = import_module(f"{pkg}.relational.engine")
    ex = import_module(f"{pkg}.relational.expr")
    return eng.Aggregate(
        eng.Filter(
            eng.Join(eng.Scan("f", ["fk", "x"]), "d", "fk", "k", ["v1", "v2"]),
            ex.Bin("gt", ex.Col("x"), ex.Const(0.0)),
        ),
        [
            ("n", "count", "x"), ("sum_x", "sum", "x"),
            ("avg_v1", "mean", "v1"), ("min_v1", "min", "v1"),
            ("max_v2", "max", "v2"),
        ],
    )


def _host_oracle(tables):
    f, d = tables["f"], tables["d"]
    pos = np.clip(np.searchsorted(d["k"], f["fk"]), 0, len(d["k"]) - 1)
    mask = (d["k"][pos] == f["fk"]) & (f["x"] > 0)
    x, v1, v2 = f["x"][mask], d["v1"][pos][mask], d["v2"][pos][mask]
    n = np.float32(mask.sum())
    return {
        "n": n,
        "sum_x": np.float32(x.astype(np.float64).sum()),
        "avg_v1": np.float32(v1.astype(np.float64).sum()) / max(n, np.float32(1)),
        "min_v1": v1.min() if len(v1) else np.float32(0),
        "max_v2": v2.max() if len(v2) else np.float32(0),
    }


def _run(pkg, tables, mode, monkeypatch, segments=None):
    monkeypatch.setenv("RAVEN_KERNELS", mode)
    eng = reng if pkg == "repro" else teng
    eng.clear_plan_cache()
    try:
        cp = eng.compile_plan(_dashboard_plan(pkg), cache=False)
        if pkg == "repro":
            db = {t: {c: jnp.asarray(v) for c, v in cs.items()}
                  for t, cs in tables.items()}
            res = cp.run(db, segments=segments)
        else:
            res = cp.run(tables, segments=segments, device="cpu")
        return {k: np.asarray(v) for k, v in res.table.to_numpy().items()}
    finally:
        monkeypatch.delenv("RAVEN_KERNELS", raising=False)
        eng.clear_plan_cache()


@pytest.mark.parametrize("mode", ["on", "off"])
def test_dashboard_global_bitwise_vs_reference_and_host(mode, monkeypatch):
    tables = _star_tables()
    got = _run("repro_torch", tables, mode, monkeypatch)
    want = _run("repro", tables, mode, monkeypatch)
    host = _host_oracle(tables)
    assert sorted(got) == sorted(want) == sorted(host)
    for k in host:
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k
        assert np.array_equal(_bits(got[k]), _bits(np.reshape(host[k], (1,)))), k


@pytest.mark.parametrize("mode", ["on", "off"])
def test_dashboard_segmented_bitwise_vs_reference(mode, monkeypatch):
    tables = _star_tables(n=150, seed=11)
    seg = np.sort(np.random.default_rng(2).integers(0, 6, size=150)).astype(np.int32)
    got = _run("repro_torch", tables, mode, monkeypatch, segments=(seg, 6))
    want = _run("repro", tables, mode, monkeypatch, segments=(seg, 6))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == (6,)
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k


def test_dashboard_join_takes_the_gather_join_op_only_when_it_qualifies(monkeypatch):
    """Unique int keys and f32 payload: the gather-join op. The upload
    demotes the int64 keys to int32, as the reference's does."""
    from repro_torch.kernels import ops

    calls = []
    real = ops.gather_join_op
    monkeypatch.setattr(ops, "gather_join_op",
                        lambda *a: calls.append(a) or real(*a))
    _run("repro_torch", _star_tables(), "on", monkeypatch)
    assert len(calls) == 1
    fk, skeys, spay = calls[0]
    assert fk.dtype == skeys.dtype == torch.int32 and spay.dtype == torch.float32
    calls.clear()
    _run("repro_torch", _star_tables(), "off", monkeypatch)
    assert calls == []


def test_uploaded_database_sorts_each_join_key_once(monkeypatch):
    """``upload_database`` keeps the host copy of integer columns; a Join's
    dim-key sort is computed once per uploaded database, from that copy,
    and every later run reuses it."""
    calls = []
    real = teng.dimsort_entry
    monkeypatch.setattr(teng, "dimsort_entry", lambda *a: calls.append(a) or real(*a))
    tables = _star_tables()
    db = teng.upload_database(tables, "cpu")
    assert teng.upload_database(db, "cpu") is db
    cp = teng.compile_plan(_dashboard_plan("repro_torch"), cache=False)
    runs = [cp.run(db, device="cpu").table.to_numpy() for _ in range(3)]
    assert len(calls) == 1
    keys, device = calls[0]
    assert isinstance(keys, np.ndarray) and keys.dtype == np.int32
    assert str(device) == "cpu"
    host = _host_oracle(tables)
    for got in runs + [cp.run(tables, device="cpu").table.to_numpy()]:
        for k in host:
            assert np.array_equal(_bits(got[k]), _bits(np.reshape(host[k], (1,)))), k


# ---------------------------------------------------------------------------
# Expressions: the port's eval_expr over torch against the reference's
# ---------------------------------------------------------------------------


def _expr_cases(ex):
    C, K, P = ex.Col, ex.Const, ex.Param
    x, y, k = C("x"), C("y"), C("k")
    return {
        "arith": ex.Bin("add", ex.Bin("mul", x, K(0.5)), ex.Bin("div", y, K(3.0))),
        "int_eq": ex.Bin("eq", k, K(1)),
        "int_float": ex.Bin("sub", k, K(0.25)),
        "param": ex.Bin("and", ex.Bin("ge", x, P("t")), ex.Bin("ne", k, K(2))),
        "case": ex.Case(ex.Bin("lt", x, y), ex.Bin("max", x, K(0.0)), ex.Un("neg", y)),
        "unary": ex.Bin("add", ex.Un("sigmoid", x),
                        ex.Un("log", ex.Un("exp", ex.Un("abs", y)))),
        "logit_sqrt": ex.Bin("min", ex.Un("logit", ex.Un("sigmoid", x)),
                             ex.Un("sqrt", ex.Un("abs", x))),
        "or": ex.Bin("or", ex.Bin("gt", x, K(1.0)), ex.Bin("le", y, K(-1.0))),
    }


@pytest.mark.parametrize("case", [
    "arith", "int_eq", "int_float", "param", "case", "unary", "logit_sqrt", "or",
])
def test_eval_expr_matches_reference(case):
    import repro.relational.expr as rex
    import repro_torch.relational.expr as tex

    rng = np.random.default_rng(8)
    cols = {
        "x": rng.normal(size=50).astype(np.float32),
        "y": rng.normal(size=50).astype(np.float32),
        "k": rng.integers(0, 4, size=50).astype(np.int32),
    }
    want = rex.eval_expr(
        _expr_cases(rex)[case], {c: jnp.asarray(v) for c, v in cols.items()},
        {"t": jnp.asarray(0.1, jnp.float32)},
    )
    got = tex.eval_expr(
        _expr_cases(tex)[case], {c: torch.from_numpy(v) for c, v in cols.items()},
        {"t": torch.tensor(0.1, dtype=torch.float32)},
    )
    assert got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Runs on the card unless told otherwise; unported paths say where they wait
# ---------------------------------------------------------------------------


def test_run_without_device_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cp = teng.compile_plan(_dashboard_plan("repro_torch"), cache=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cp.run(_star_tables())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.execute_plan(_dashboard_plan("repro_torch"), _star_tables())
    assert cp.run(_star_tables(), device="cpu").table.n_rows == 1


@pytest.mark.parametrize("transform", ["sql", "none", None])
def test_unported_transforms_raise(hospital_case, transform):
    _, port_pipe, infer, _ = hospital_case
    q = parse_prediction_query(QUERY, {"m": port_pipe}, infer.tables)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RavenOptimizer(options=OptimizerOptions(transform=transform)).optimize(q)


def test_plan_with_host_boundary_raises():
    from repro_torch.exec.stages import build_stage_graph

    plan = teng.MLUdf(teng.Scan("f", ["x"]), pipeline=None, output_names=["y"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_stage_graph(plan)
