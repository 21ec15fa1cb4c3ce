"""The port's plan verifier (``repro_torch.analysis``) against the
reference's ``repro.analysis`` on the same plans.

Both packages lower the same toy query (a featurize + linear pipeline, with
a host-only ``python_udf`` for the split lowering) under each runtime; every
lowering verifies clean in the port, and a verified plan executes. Each
corruption of the reference's rejection tests (``tests/test_analysis.py``)
is applied to both packages' graphs: the port rejects it with the
reference's rule id, and both report the same set of rule ids. The exec
checks run each pure stage on zero-filled inputs (the port's counterpart of
``jax.eval_shape``), so their corruptions are written once per package, in
torch and in jnp. The verify modes thread through ``connect``/``prepare``/
``explain``, ``RAVEN_VERIFY`` and the query server's ``register`` as in the
reference, and never change a fingerprint.
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro as jraven
import repro.analysis.verifier as jver
import repro.core.ir as jir
import repro.core.optimizer as jopt
import repro.exec.stages as jstages
import repro.ml.pipeline as jpipe
import repro.relational.engine as jeng
import repro.relational.expr as jexpr
import repro_torch as raven
import repro_torch.analysis.verifier as tver
import repro_torch.core.ir as tir
import repro_torch.core.optimizer as topt
import repro_torch.exec.stages as tstages
import repro_torch.ml.pipeline as tpipe
import repro_torch.relational.engine as teng
import repro_torch.relational.expr as texpr
from repro.analysis.rules import rule_catalog as j_rule_catalog
from repro_torch.analysis import VerificationWarning, rule_catalog
from repro_torch.errors import PlanVerificationError
from repro_torch.serve.query_server import PredictionQueryServer

PORT = {"pipe": tpipe, "ir": tir, "opt": topt, "stages": tstages, "eng": teng,
        "expr": texpr, "ver": tver}
REF = {"pipe": jpipe, "ir": jir, "opt": jopt, "stages": jstages, "eng": jeng,
       "expr": jexpr, "ver": jver}


def rule_ids(violations):
    return {v.rule for v in violations}


def exec_check(pkg, graph, tables):
    """``check_exec`` of ``pkg``, the port's on the CPU."""
    if pkg is PORT:
        return tver.check_exec(graph, tables, device="cpu")
    return pkg["ver"].check_exec(graph, tables)


def toy_tables(n=32, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "t": {
            "a": rng.normal(size=n),
            "b": rng.normal(size=n),
            "k": rng.integers(0, 8, size=n).astype(np.int32),
        }
    }


def _bump(x):
    return x + 0.125


_bump.__fingerprint_token__ = "analysis-cli-python-udf-v1"


def toy_pipeline(pkg=PORT, with_udf: bool = False):
    """The reference analysis gate's hand-built featurize + linear pipeline
    (fixed weights), built from ``pkg``'s pipeline classes."""
    P = pkg["pipe"]
    nodes = [
        P.PipelineNode("concat", ["a", "b"], ["num_raw"], {}),
        P.PipelineNode("scaler", ["num_raw"], ["num_scaled"],
                       {"offset": np.array([0.1, -0.2]), "scale": np.array([1.5, 0.75])}),
        P.PipelineNode("concat", ["num_scaled"], ["features"], {}),
    ]
    feat = "features"
    if with_udf:
        nodes.append(P.PipelineNode("python_udf", [feat], ["tweaked"], {"fn": _bump}))
        feat = "tweaked"
    nodes.append(P.PipelineNode(
        "linear", [feat], ["score", "label"],
        {"weights": np.array([0.8, -0.5]), "bias": 0.25, "post": "logistic"},
    ))
    return P.TrainedPipeline(
        inputs=[P.InputSpec("a", "numeric"), P.InputSpec("b", "numeric")],
        outputs=["score", "label"], nodes=nodes,
    )


def lower(transform, pkg=PORT, *, with_udf=False, filt=False, agg=False, tables=None):
    """Optimize the toy query in ``pkg`` down to a StageGraph (verification
    off)."""
    tables = tables if tables is not None else toy_tables()
    ir, E = pkg["ir"], pkg["expr"]
    plan = ir.LPredict(ir.LScan("t", ["a", "b", "k"]), toy_pipeline(pkg, with_udf),
                       ["score", "label"])
    if filt:
        plan = ir.LFilter(plan, E.Bin("gt", E.Col("score"), E.Const(0.5)))
    if agg:
        plan = ir.LAggregate(plan, [("n", "count", ""), ("avg_score", "mean", "score")])
    opts = pkg["opt"].OptimizerOptions(transform=transform, verify="off")
    physical, _ = pkg["opt"].RavenOptimizer(options=opts).optimize(ir.PredictionQuery(plan))
    return pkg["stages"].build_stage_graph(physical), tables


@pytest.fixture(autouse=True)
def _fresh_exec_memo(monkeypatch):
    # corruptions must not be masked by a memoized verdict; the mode comes
    # from each test, not from the environment the suite runs in
    monkeypatch.delenv("RAVEN_VERIFY", raising=False)
    tver._EXEC_MEMO.clear()
    jver._EXEC_MEMO.clear()
    yield
    tver._EXEC_MEMO.clear()
    jver._EXEC_MEMO.clear()


# ---------------------------------------------------------------------------
# The registry, and every lowering verifying clean
# ---------------------------------------------------------------------------


def test_rule_catalog_is_the_reference_s():
    assert [(r.id, r.scope) for r in rule_catalog()] == [
        (r.id, r.scope) for r in j_rule_catalog()]


LOWERINGS = [("dnn", False, False, False), ("dnn", True, False, False),
             ("dnn", True, True, True), ("sql", False, True, False),
             ("sql", False, False, True), ("none", False, True, True)]


@pytest.mark.parametrize("transform,with_udf,filt,agg", LOWERINGS)
def test_every_lowering_verifies_clean_and_executes(transform, with_udf, filt, agg):
    tables = toy_tables(n=21, seed=3)
    graph, _ = lower(transform, with_udf=with_udf, filt=filt, agg=agg, tables=tables)
    ref, _ = lower(transform, REF, with_udf=with_udf, filt=filt, agg=agg, tables=tables)
    assert [s.kind for s in graph.stages] == [s.kind for s in ref.stages]
    assert [s.in_columns for s in graph.stages] == [s.in_columns for s in ref.stages]
    assert graph.needs_segments == ref.needs_segments
    assert tver.check_graph(graph) == []
    assert exec_check(PORT, graph, tables) == []
    out = teng.compile_plan(graph.plan).run(tables, device="cpu").table.to_numpy()
    assert out
    for c, v in out.items():
        assert np.all(np.isfinite(np.asarray(v, dtype=np.float64))), c


def test_join_and_aggregate_plan_verifies_clean_on_an_uploaded_database():
    """A filter → join → aggregate plan over a star schema: the abstract run
    reads the dim table and its baked join sort from the database where it
    lies."""
    rng = np.random.default_rng(0)
    tables = {
        "f": {"fk": rng.integers(0, 40, 64).astype(np.int64), "x": rng.normal(size=64)},
        "d": {"k": np.arange(32, dtype=np.int64), "v": rng.normal(size=32)},
    }

    def plan(E, eng):
        return eng.Aggregate(
            eng.Filter(eng.Join(eng.Scan("f", ["fk", "x"]), "d", "fk", "k", ["v"]),
                       E.Bin("gt", E.Col("x"), E.Const(0.0))),
            [("n", "count", "x"), ("s", "sum", "v"), ("m", "max", "v")],
        )

    graph = tstages.build_stage_graph(plan(texpr, teng))
    db = teng.upload_database(tables, "cpu")
    assert tver.check_graph(graph) == []
    assert exec_check(PORT, graph, db) == []
    assert exec_check(PORT, graph, tables) == []
    assert "unique" in db.dimsort("d", "k")
    assert jver.check_exec(jstages.build_stage_graph(plan(jexpr, jeng)), tables) == []


def test_abstract_run_goes_to_the_card_unless_the_cpu_is_asked(monkeypatch):
    """Tables given as arrays: the abstract run goes to the card by default
    (raising where there is none) and to the CPU only when asked; an
    uploaded database is run where it lies."""
    tables = toy_tables(n=21, seed=3)
    graph, _ = lower("dnn", tables=tables)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tver._EXEC_MEMO.clear()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tver.check_exec(graph, tables)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tver.verify_graph(graph, tables, mode="strict")
    assert tver.check_exec(graph, tables, device="cpu") == []
    assert tver.check_exec(graph, teng.upload_database(tables, "cpu")) == []


def test_split_lowering_has_expected_shape():
    graph, _ = lower("dnn", with_udf=True)
    assert [s.kind for s in graph.stages] == ["pure", "host", "pure"]
    assert graph.stages[1].udf.consumes


# ---------------------------------------------------------------------------
# Negative: one corruption, one named rule, the same ids in both packages
# ---------------------------------------------------------------------------


class FlakyFn:
    calls = 0

    @property
    def __fingerprint_token__(self):
        FlakyFn.calls += 1
        return f"tok-{FlakyFn.calls}"

    def __call__(self, cols):
        return cols


def _host_op_in_pure_stage(graph, pkg):
    udf = pkg["eng"].MLUdf(None, toy_pipeline(pkg), ("score", "label"), 64, ())
    graph.stages[0].ops.append(udf)


def _address_token(graph, pkg):
    op = graph.stages[0].ops[-1]
    op.fn.__fingerprint_token__ = f"closure at 0x{id(op):x}"


# name -> (lowering kwargs, corruption, rule the reference's test expects)
GRAPH_CORRUPTIONS = {
    "noncontiguous-indices": ({}, lambda g, p: setattr(g.stages[0], "index", 5),
                              "graph-shape"),
    "unknown-kind": ({}, lambda g, p: setattr(g.stages[0], "kind", "quantum"),
                     "graph-shape"),
    "phantom-out-column": ({}, lambda g, p: setattr(
        g.stages[-1], "out_columns", g.stages[-1].out_columns + ("phantom",)),
        "schema-chain"),
    "dropped-consume": ({"with_udf": True}, lambda g, p: setattr(
        g.stages[1].udf, "consumes", ()), "consumes-balance"),
    "pv-in-output-schema": ({"with_udf": True}, lambda g, p: setattr(
        g.stages[-1], "out_columns", g.stages[-1].out_columns + ("__pv_features",)),
        "block-leak"),
    "host-op-in-pure-stage": ({}, _host_op_in_pure_stage, "placement-pure"),
    "oversized-residual": ({"with_udf": True}, lambda g, p: setattr(
        g.stages[1].udf, "pipeline", toy_pipeline(p, with_udf=False)), "residual-minimal"),
    "corrupted-chain": ({}, lambda g, p: setattr(g.stages[-1], "fingerprint", "deadbeef" * 8),
                        "fingerprint-stable"),
    "address-bearing-token": ({}, _address_token, "fingerprint-stable"),
    "unstable-token": ({}, lambda g, p: setattr(g.stages[0].ops[-1], "fn", FlakyFn()),
                       "fingerprint-deterministic"),
    "leaked-block-column": ({"with_udf": True}, lambda g, p: setattr(
        g.stages[-1], "out_columns", g.stages[-1].out_columns + ("__pv_tweaked",)),
        "block-leak"),
    "double-consume": ({"with_udf": True}, lambda g, p: setattr(
        g.stages[1].udf, "consumes", tuple(g.stages[1].udf.consumes) * 2),
        "consumes-balance"),
}


@pytest.mark.parametrize("name", sorted(GRAPH_CORRUPTIONS))
def test_graph_corruption_is_rejected_with_the_reference_s_rule(name):
    kwargs, corrupt, rule = GRAPH_CORRUPTIONS[name]
    got = {}
    for label, pkg in (("port", PORT), ("ref", REF)):
        graph, _ = lower("dnn", pkg, **kwargs)
        assert pkg["ver"].check_graph(graph) == []
        corrupt(graph, pkg)
        vs = pkg["ver"].check_graph(graph)
        got[label] = rule_ids(vs)
        if label == "port":
            assert any(str(v).startswith(f"[{rule}]") for v in vs), vs
            if name == "dropped-consume":
                assert "__pv_" in "\n".join(str(v) for v in vs)
            if name == "address-bearing-token":
                assert any("address" in v.message or "0x" in v.message for v in vs)
    assert rule in got["port"]
    assert got["port"] == got["ref"]


def _drifting(st, half, cast):
    def fn(env, _orig=st.fn):
        cols, valid, seg = _orig(env)
        if valid.shape[0] == 16:
            cols = {k: (cast(v) if k == "score" else v) for k, v in cols.items()}
        return cols, valid, seg
    return fn


def _padded(st, cat):
    def fn(env, _orig=st.fn):
        cols, valid, seg = _orig(env)
        cols = dict(cols)
        cols["score"] = cat(cols["score"])
        return cols, valid, seg
    return fn


def _dropping(st):
    def fn(env, _orig=st.fn):
        cols, valid, _seg = _orig(env)
        return cols, valid, None
    return fn


# name -> (lowering kwargs, stage index, wrap(stage, pkg) -> fn, rule)
EXEC_CORRUPTIONS = {
    "bucket-dependent-dtype": ({}, 0, lambda st, p: _drifting(
        st, 16, (lambda v: v.to(torch.float16)) if p is PORT
        else (lambda v: v.astype(jnp.float16))), "schema-dtype"),
    "non-polymorphic-rows": ({}, 0, lambda st, p: _padded(
        st, (lambda v: torch.cat([v, v.new_zeros((1,))])) if p is PORT
        else (lambda v: jnp.concatenate([v, jnp.zeros((1,), v.dtype)]))), "bucket-safety"),
    "dropped-seg": ({"agg": True}, -1, lambda st, p: _dropping(st), "segment-threading"),
    "float-validity-mask": ({}, 0, lambda st, p: (
        lambda env, _orig=st.fn: (lambda c, v, s: (
            c, v.to(torch.float32) if p is PORT else v.astype(jnp.float32), s))(
            *_orig(env))), "schema-dtype"),
    "missing-output-column": ({}, 0, lambda st, p: (
        lambda env, _orig=st.fn: (lambda c, v, s: (
            {k: x for k, x in c.items() if k != "score"}, v, s))(*_orig(env))),
        "schema-exec"),
}


@pytest.mark.parametrize("name", sorted(EXEC_CORRUPTIONS))
def test_exec_corruption_is_rejected_with_the_reference_s_rule(name):
    kwargs, index, wrap, rule = EXEC_CORRUPTIONS[name]
    got = {}
    for label, pkg in (("port", PORT), ("ref", REF)):
        graph, tables = lower("dnn", pkg, **kwargs)
        if name == "dropped-seg":
            assert graph.needs_segments
        assert exec_check(pkg, graph, tables) == []
        st = graph.stages[index]
        st.fn = wrap(st, pkg)
        st.fingerprint += f":{name}"
        got[label] = rule_ids(exec_check(pkg, graph, tables))
    assert rule in got["port"]
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("case", ["unknown-column", "unknown-table"])
def test_schema_exec_rejects_unknown_sources(case):
    for pkg in (PORT, REF):
        graph, tables = lower("dnn", pkg)
        if case == "unknown-column":
            del tables["t"]["b"]
        else:
            tables = {}
        assert rule_ids(exec_check(pkg, graph, tables)) == {"schema-exec"}


def _dup_producer(P):
    return P.TrainedPipeline(
        inputs=[P.InputSpec("a", "numeric")], outputs=["x"],
        nodes=[P.PipelineNode("concat", ["a"], ["x"], {}),
               P.PipelineNode("concat", ["a"], ["x"], {})],
    )


def _unproduced(P):
    return P.TrainedPipeline(
        inputs=[P.InputSpec("a", "numeric")], outputs=["ghost"],
        nodes=[P.PipelineNode("concat", ["a"], ["x"], {})],
    )


LOGICAL_CORRUPTIONS = {
    "duplicate-producer": (lambda p: p["ir"].LPredict(
        p["ir"].LScan("t", ["a"]), _dup_producer(p["pipe"]), ["x"]), "pipeline-graph"),
    "unproduced-output": (lambda p: p["ir"].LPredict(
        p["ir"].LScan("t", ["a"]), _unproduced(p["pipe"]), ["ghost"]), "pipeline-graph"),
    "unknown-filter-column": (lambda p: p["ir"].LFilter(
        p["ir"].LScan("t", ["a"]),
        p["expr"].Bin("gt", p["expr"].Col("nope"), p["expr"].Const(0.0))), "logical-schema"),
}


@pytest.mark.parametrize("name", sorted(LOGICAL_CORRUPTIONS))
def test_logical_corruption_is_rejected_with_the_reference_s_rule(name):
    build, rule = LOGICAL_CORRUPTIONS[name]
    vs = tver.check_logical(tir.PredictionQuery(build(PORT)))
    ref = jver.check_logical(jir.PredictionQuery(build(REF)))
    assert rule in rule_ids(vs)
    assert rule_ids(vs) == rule_ids(ref)
    assert [v.message for v in vs] == [v.message for v in ref]


# ---------------------------------------------------------------------------
# Modes: off / warn / strict, the env default, session + prepare + register
# ---------------------------------------------------------------------------


def test_resolve_modes(monkeypatch):
    assert tver.resolve_verify_mode(None) == "off"
    assert tver.resolve_verify_mode(True) == "strict"
    assert tver.resolve_verify_mode(False) == "off"
    assert tver.resolve_verify_mode("warn") == "warn"
    monkeypatch.setenv("RAVEN_VERIFY", "strict")
    assert tver.resolve_verify_mode(None) == "strict"
    with pytest.raises(ValueError):
        tver.resolve_verify_mode("loud")


def test_enforce_strict_raises_with_violations():
    graph, _ = lower("dnn", with_udf=True)
    graph.stages[1].udf.consumes = ()
    vs = tver.check_graph(graph)
    with pytest.raises(PlanVerificationError) as ei:
        tver.enforce(vs, "strict", "test")
    assert ei.value.violations == vs
    assert "consumes-balance" in str(ei.value)


def test_enforce_warn_warns():
    graph, _ = lower("dnn", with_udf=True)
    graph.stages[1].udf.consumes = ()
    vs = tver.check_graph(graph)
    with pytest.warns(VerificationWarning):
        lines = tver.enforce(vs, "warn", "test")
    assert lines and any("consumes-balance" in ln for ln in lines)


def test_enforce_off_and_clean():
    assert tver.enforce([], "off", "x") == []
    assert tver.enforce([], "strict", "x") == ["x: ok"]


def _connect(pkg, tables, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if pkg is raven:
            kw["device"] = "cpu"
        return pkg.connect(tables, **kw)


@pytest.mark.parametrize("transform", ["dnn", "sql", "none"])
def test_strict_session_prepares_and_explains_as_the_reference(transform):
    ex = {}
    for pkg in (raven, jraven):
        db = _connect(pkg, toy_tables(), verify="strict")
        db.register_model("m", toy_pipeline(PORT if pkg is raven else REF))
        prep = db.table("t").predict("m").prepare(transform=transform)
        ex[pkg] = prep.report.verification
        text = prep.explain()
        assert "plan verification" in text
        assert "prepare (stage graph): ok" in text
        assert "after lowering: ok" in text
        db.close()
    assert ex[raven] == ex[jraven]


def test_strict_prepare_raises_on_a_corrupted_lowering(monkeypatch):
    """A lowering that declares a phantom output column is refused at
    prepare under ``verify="strict"`` and only warned about under
    ``"warn"``."""
    db = _connect(raven, toy_tables())
    db.register_model("m", toy_pipeline())
    real = tstages.build_stage_graph

    def phantom(plan, pins=None):
        graph = real(plan, pins)
        graph.stages[-1].out_columns += ("phantom",)
        return graph

    monkeypatch.setattr(tstages, "build_stage_graph", phantom)
    with pytest.raises(PlanVerificationError) as ei:
        db.table("t").predict("m").prepare(transform="dnn", verify="strict")
    assert "schema-chain" in {v.rule for v in ei.value.violations}
    with pytest.warns(VerificationWarning):
        prep = db.table("t").predict("m").prepare(transform="sql", verify="warn")
    assert any("schema-chain" in ln for ln in prep.report.verification)
    db.close()


def test_verify_mode_never_changes_fingerprints():
    db = _connect(raven, toy_tables())
    db.register_model("m", toy_pipeline())
    fps = {
        db.table("t").predict("m").prepare(transform=tr, verify=v).fingerprint
        for v in (None, True, "warn", "off") for tr in ("sql",)
    }
    assert len(fps) == 1
    db.close()


def test_env_default_applies(monkeypatch):
    monkeypatch.setenv("RAVEN_VERIFY", "strict")
    db = _connect(raven, toy_tables())
    db.register_model("m", toy_pipeline())
    prep = db.table("t").predict("m").prepare(transform="dnn")
    assert "plan verification" in prep.explain()
    assert prep.report.verification[-1] == "prepare (stage graph): ok"
    db.close()


def test_register_reverifies_the_served_graph():
    srv = PredictionQueryServer(options=topt.OptimizerOptions(transform="dnn", verify="strict"),
                                device="cpu")
    q = tir.PredictionQuery(tir.LPredict(tir.LScan("t", ["a", "b", "k"]),
                                         toy_pipeline(with_udf=True), ["score", "label"]))
    reg = srv.register("toy", q, toy_tables())
    assert "register 'toy': ok" in reg.report.verification
    assert "after lowering: ok" in reg.report.verification
    srv.shutdown()
