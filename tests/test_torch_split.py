"""Split MLtoDNN lowering and the host ML runtime in the port, on the CPU.

The port's ``split_pipeline``/``select_cut`` (copies of the reference's)
give the reference's placements, segments and cost decisions for every
split shape: residual first, in the middle, last, and none. Executing a
split — compiled tensor prefix, host residual, compiled tensor suffix — is
bitwise equal to the host ``run_pipeline``, subnormal and signed-zero
inputs, offsets and scales included: torch on the CPU flushes no subnormal
(the reference's own split does, through XLA, which is why its property
test is held to the host and not to it here). End to end, the optimizer
emits ``TensorOp → MLUdf → TensorOp`` for a pipeline with a ``python_udf``,
and ``transform="none"`` (one MLUdf, the default) and the split query
through ``repro_torch.connect(..., device="cpu")`` give ``repro.connect``'s
answers: COUNT exactly, AVG within ``rtol=1e-5``, scores within the
reference split test's ``rtol=5e-3, atol=1e-5``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro as jraven
import repro.ml.pipeline as rpl
import repro_torch as raven
import repro_torch.ml.pipeline as tpl
from repro.core.cost import CostModel as RefCostModel
from repro.core.rules.ml_to_dnn import (
    compile_pipeline_to_dnn_partial as ref_partial,
)
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.tensor.compile import tensor_supported as ref_supported
from repro_torch.core.cost import CostModel
from repro_torch.core.rules.ml_to_dnn import (
    MLtoDNNUnsupported,
    compile_pipeline_to_dnn_partial,
)
from repro_torch.exec import stages as tstages
from repro_torch.relational import engine as teng
from repro_torch.tensor.compile import tensor_supported
from tests.conftest import train_pipeline

UDF_POS = ["none", "start", "middle", "end"]
F32_SPECIAL = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 9.5e-43, -3e-39, np.finfo(np.float32).tiny,
     -np.finfo(np.float32).tiny, 1.0, -1.0, 1e3, -1e3], np.float32)


def _udf(X):
    # deterministic, elementwise, float32-exact
    return (X.astype(np.float32) * np.float32(0.5)) + np.float32(0.25)


_udf.__fingerprint_token__ = "test-torch-split-udf-v1"


def _build(pl, k: int, offsets, scales, udf_pos: str):
    """k numeric inputs -> concat -> scaler -> feature_extractor, with a
    python_udf at ``udf_pos``, built with package module ``pl``."""
    xs = [f"x{i}" for i in range(k)]
    nodes = []
    off = np.asarray(offsets, dtype=np.float32)
    sc = np.asarray(scales, dtype=np.float32)
    if udf_pos == "start":
        nodes.append(pl.PipelineNode("python_udf", [xs[0]], ["h0"], {"fn": _udf}))
        concat_in = ["h0", *xs[1:]]
    else:
        concat_in = list(xs)
    nodes.append(pl.PipelineNode("concat", concat_in, ["raw"]))
    scaler_in = "raw"
    if udf_pos == "middle":
        nodes.append(pl.PipelineNode("python_udf", ["raw"], ["raw_h"], {"fn": _udf}))
        scaler_in = "raw_h"
    nodes.append(pl.PipelineNode("scaler", [scaler_in], ["scaled"],
                                 {"offset": off, "scale": sc}))
    nodes.append(pl.PipelineNode("feature_extractor", ["scaled"], ["feat"],
                                 {"indices": list(reversed(range(k)))}))
    final = "feat"
    if udf_pos == "end":
        nodes.append(pl.PipelineNode("python_udf", ["feat"], ["feat_h"], {"fn": _udf}))
        final = "feat_h"
    return pl.TrainedPipeline(
        inputs=[pl.InputSpec(x, "numeric") for x in xs], outputs=[final], nodes=nodes)


def _draw(rng, size) -> np.ndarray:
    """float32 values in [-1e3, 1e3], a third of them subnormals, signed
    zeros and other edges."""
    x = rng.uniform(-1e3, 1e3, size).astype(np.float32)
    pick = rng.random(size) < 0.35
    x[pick] = rng.choice(F32_SPECIAL, size=int(pick.sum()))
    return x


def _bits(a) -> np.ndarray:
    a = np.asarray(a, dtype=np.float32)
    width = int(np.prod(a.shape[1:])) if a.ndim > 1 else 1
    return np.ascontiguousarray(a.reshape(a.shape[0], width)).view(np.uint32)


def _segment_view(seg):
    if seg is None:
        return None
    p = seg.pipeline
    return ([(s.name, s.kind) for s in p.inputs], list(p.outputs),
            [(n.op, list(n.inputs), list(n.outputs)) for n in p.nodes],
            list(seg.out_cols), list(seg.consumes))


def _decision_view(d):
    return None if d is None else (d.choice, d.split_s, d.monolithic_s, d.rows, d.note())


# ---------------------------------------------------------------------------
# The split and its cost decision, against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cost", ["default", "costly boundary"])
@pytest.mark.parametrize("udf_pos", UDF_POS)
def test_split_and_cut_decision_match_reference(udf_pos, cost):
    kw = {} if cost == "default" else {"crossing_ns_per_row": 1e6, "segment_fixed_us": 1e9}
    args = (3, [0.0, 1.0, 2.0], [1.0, 0.5, 2.0], udf_pos)
    ref_pipe, pipe = _build(rpl, *args), _build(tpl, *args)
    want, want_d = rpl.select_cut(ref_pipe, ref_supported, rename={"feat": "f"},
                                  cost_model=RefCostModel(**kw), rows=50_000)
    got, got_d = tpl.select_cut(pipe, tensor_supported, rename={"feat": "f"},
                                cost_model=CostModel(**kw), rows=50_000)
    assert got.placement == want.placement
    assert got.fully_supported == want.fully_supported == (udf_pos == "none")
    for part in ("prefix", "residual", "suffix"):
        assert _segment_view(getattr(got, part)) == _segment_view(getattr(want, part))
    assert _decision_view(got_d) == _decision_view(want_d)
    if udf_pos != "none":
        assert got_d.choice == ("split" if cost == "default" else "monolithic")
    # the lowering takes the same shape
    ref_part = ref_partial(ref_pipe, cost_model=RefCostModel(**kw))
    part = compile_pipeline_to_dnn_partial(pipe, cost_model=CostModel(**kw), device="cpu")
    for f in ("full", "prefix", "residual", "suffix"):
        assert (getattr(part, f) is None) == (getattr(ref_part, f) is None), f
    assert _decision_view(part.decision) == _decision_view(ref_part.decision)


def test_nothing_lowerable_raises():
    pipe = tpl.TrainedPipeline(
        inputs=[tpl.InputSpec("x0", "numeric")], outputs=["h"],
        nodes=[tpl.PipelineNode("python_udf", ["x0"], ["h"], {"fn": _udf})],
    )
    with pytest.raises(MLtoDNNUnsupported, match="no supported prefix or suffix"):
        compile_pipeline_to_dnn_partial(pipe, device="cpu")


# ---------------------------------------------------------------------------
# Split execution is bitwise the host interpreter's
# ---------------------------------------------------------------------------


def _run_split(pipe, inputs: dict[str, np.ndarray]):
    """Prefix (tensor) -> residual (host) -> suffix (tensor), chained
    through the cut columns as the plan chains them."""
    part = compile_pipeline_to_dnn_partial(pipe, device="cpu")
    cols = dict(inputs)

    def tensor_seg(comp, names, outs):
        res = comp.fn({n: torch.from_numpy(np.array(cols[n])) for n in comp.input_names})
        for val, col in zip(outs, names):
            cols[col] = res[val].numpy()

    if part.full is not None:
        tensor_seg(part.full, pipe.outputs, pipe.outputs)
        return cols, part
    if part.prefix is not None:
        comp, seg = part.prefix
        tensor_seg(comp, seg.out_cols, seg.pipeline.outputs)
    seg = part.residual
    res = tpl.run_pipeline(seg.pipeline, {s.name: cols[s.name] for s in seg.pipeline.inputs})
    for val, col in zip(seg.pipeline.outputs, seg.out_cols):
        cols[col] = res[val]
    if part.suffix is not None:
        comp, seg = part.suffix
        tensor_seg(comp, seg.out_cols, seg.pipeline.outputs)
    return cols, part


@pytest.mark.parametrize("udf_pos", UDF_POS)
@pytest.mark.parametrize("k,n,seed", [(1, 0, 0), (1, 7, 1), (3, 37, 2), (4, 128, 3),
                                      (2, 257, 4)])
def test_split_execution_matches_host_bitwise(k, n, seed, udf_pos):
    rng = np.random.default_rng(seed)
    offsets, scales = _draw(rng, k), _draw(rng, k)
    arr = _draw(rng, (n, k))
    pipe = _build(tpl, k, offsets, scales, udf_pos)
    inputs = {f"x{i}": arr[:, i] for i in range(k)}
    host = tpl.run_pipeline(pipe, inputs)
    ref_host = rpl.run_pipeline(_build(rpl, k, offsets, scales, udf_pos), inputs)
    got, part = _run_split(pipe, inputs)
    if udf_pos == "none":
        assert part.full is not None
    else:
        assert part.residual is not None
        assert (part.prefix is None) == (udf_pos == "start")
        assert (part.suffix is None) == (udf_pos == "end")
    o = pipe.outputs[0]
    want = _bits(host[o])
    assert np.array_equal(want, _bits(ref_host[o]))
    assert _bits(got[o]).shape == want.shape == (n, k)
    assert np.array_equal(_bits(got[o]), want), "bitwise mismatch"


@pytest.mark.parametrize("udf_pos", UDF_POS)
@pytest.mark.parametrize("n", [0, 37])
def test_split_plan_through_the_engine_matches_host_bitwise(udf_pos, n):
    """The optimizer's plan, run by ``CompiledPlan.run`` on the CPU: the
    host stage's copies, compaction and upload change no bit, and a
    zero-row boundary keeps every output's trailing shape."""
    from repro_torch.core.ir import LPredict, LScan, PredictionQuery
    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer

    rng = np.random.default_rng(n)
    offsets, scales = _draw(rng, 1), _draw(rng, 1)
    arr = _draw(rng, n)
    pipe = _build(tpl, 1, offsets, scales, udf_pos)
    final = pipe.outputs[0]
    q = PredictionQuery(plan=LPredict(LScan("t", ["x0"]), pipe, [final]))
    # model-projection pushdown cannot size a python_udf's output (in either
    # package), and there is no model to push into here
    plan, report = RavenOptimizer(options=OptimizerOptions(
        transform="dnn", projection_pushdown=False)).optimize(q)
    kinds = [s.split(":")[0] for s in report.stages]
    want_kinds = {"none": ["pure"], "start": ["pure", "host", "pure"],
                  "middle": ["pure", "host", "pure"], "end": ["pure", "host"]}
    assert kinds == want_kinds[udf_pos]
    out = teng.compile_plan(plan).run({"t": {"x0": arr}}, device="cpu").table.to_numpy()
    assert not [c for c in out if c.startswith("__pv_")]
    host = tpl.run_pipeline(pipe, {"x0": arr})[final]
    assert out[final].shape[0] == n
    assert np.array_equal(_bits(out[final]), _bits(host))


def test_zero_row_host_boundary_keeps_trailing_shape_and_buckets():
    """``host_step`` on a state with no valid row: the block column keeps
    its (0, k) shape; with a bucketer the output is padded, pad rows
    invalid, the segment ids padded too."""
    pipe = _build(tpl, 3, [0.0, 1.0, 2.0], [1.0, 0.5, 2.0], "middle")
    part = compile_pipeline_to_dnn_partial(pipe, device="cpu")
    udf = teng.MLUdf(teng.Scan("t", ["x0"]), part.residual.pipeline,
                     list(part.residual.out_cols), consumes=tuple(part.residual.consumes))
    stage = tstages.Stage(index=1, kind="host", ops=[udf], fingerprint="", out_columns=(),
                          udf=udf)
    block = part.residual.pipeline.inputs[0].name
    cols = {block: torch.ones((5, 3)), "x0": torch.arange(5, dtype=torch.float32)}
    seg = torch.arange(5, dtype=torch.int32)
    for valid, bucket, n in ((torch.zeros(5, dtype=torch.bool), None, 0),
                             (torch.tensor([1, 0, 1, 0, 0], dtype=torch.bool), 4, 2)):
        seen = []
        (out, v, s), env = tstages.host_step(
            stage, (cols, valid, seg), {},
            bucketer=None if bucket is None else (lambda m, b=bucket: max(b, m)),
            on_mid_bucket=lambda i, b: seen.append((i, b)))
        rows = n if bucket is None else bucket
        assert seen == [(1, rows)]
        assert block not in out  # consumed here
        (name,) = part.residual.out_cols
        assert tuple(out[name].shape) == (rows, 3) and out[name].dtype == torch.float32
        assert tuple(out["x0"].shape) == (rows,)
        assert v.dtype == torch.bool and v.tolist() == [True] * n + [False] * (rows - n)
        assert s.dtype == torch.int32 and s[:n].tolist() == [0, 2][:n]
        assert env[tstages.MID_TABLE][name] is out[name]
    assert set(stage.host_s) == {"sync", "down", "udf", "up"}


# ---------------------------------------------------------------------------
# Through the front door, against repro.connect
# ---------------------------------------------------------------------------

QUERY = ("SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) AS p "
         "WHERE asthma = 1 AND score >= :t")


def _split_pipeline(pl, pipe):
    """The hospital pipeline with a python_udf over its feature block before
    the model (the reference split test's construction)."""
    nodes = list(pipe.nodes)
    mi = next(i for i, nd in enumerate(nodes) if nd.op in ("tree_ensemble", "linear"))
    udf = pl.PipelineNode("python_udf", [nodes[mi].inputs[0]], ["features_h"], {"fn": _udf})
    model = dataclasses.replace(nodes[mi], inputs=["features_h", *nodes[mi].inputs[1:]])
    return dataclasses.replace(pipe, nodes=[*nodes[:mi], udf, model, *nodes[mi + 1:]])


@pytest.fixture(scope="module")
def split_case(hospital, tmp_path_factory):
    """(reference pipeline, port pipeline) for the plain gb pipeline and its
    split form, and the host scores of both."""
    ref_pipe = train_pipeline(hospital, "gb")
    path = str(tmp_path_factory.mktemp("m") / "gb.npz")
    ref_save_pipeline(ref_pipe, path)
    port_pipe = tpl.load_pipeline(path)
    joined = hospital.joined_columns()
    pipes = {"plain": (ref_pipe, port_pipe),
             "split": (_split_pipeline(rpl, ref_pipe), _split_pipeline(tpl, port_pipe))}
    scores = {k: np.asarray(tpl.run_pipeline(p, {s.name: joined[s.name] for s in p.inputs})
                            ["score"]).reshape(-1) for k, (_, p) in pipes.items()}
    return pipes, scores


def _sessions(tables, ref_pipe, port_pipe):
    ref_db = jraven.connect(tables)
    ref_db.register_model("m", ref_pipe)
    db = raven.connect(tables, device="cpu")
    db.register_model("m", port_pipe)
    return ref_db, db


def _gap_threshold(scores, mask, q: float, min_gap: float = 2e-5) -> float:
    s = np.unique(np.asarray(scores[mask], np.float64))
    i = int(q * (len(s) - 2))
    j = i + int(np.argmax(np.diff(s[i : i + 201])))
    assert s[j + 1] - s[j] >= min_gap
    return float(np.float32((s[j] + s[j + 1]) / 2))


def test_optimizer_emits_split_not_monolithic_udf(hospital, split_case):
    pipes, scores = split_case
    ref_db, db = _sessions(hospital.tables, *pipes["split"])
    prep = db.table("patients").predict("m").prepare(transform="dnn")
    ref_prep = ref_db.table("patients").predict("m").prepare(transform="dnn")
    kinds = [type(s).__name__ for s in teng.walk_plan(prep.plan)
             if isinstance(s, (teng.MLUdf, teng.TensorOp))]
    assert kinds == ["TensorOp", "MLUdf", "TensorOp"]  # suffix, residual, prefix
    udf = next(s for s in teng.walk_plan(prep.plan) if isinstance(s, teng.MLUdf))
    assert len(udf.pipeline.nodes) == 1  # the minimal residual
    assert [s.kind for s in prep.compiled.stages] == ["pure", "host", "pure"]
    assert prep.report.placement == ref_prep.report.placement
    assert prep.report.stages == ref_prep.report.stages
    out, want = prep(), ref_prep()
    assert sorted(out) == sorted(want)
    assert not [c for c in out if c.startswith("__pv_")]
    np.testing.assert_allclose(out["score"], scores["split"], rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(out["score"], np.asarray(want["score"]), rtol=5e-3, atol=1e-5)
    text = prep.explain()
    assert "split across runtimes" in text
    assert "host/residual" in text and "tensor/prefix" in text and "tensor/suffix" in text
    assert "MLtoDNN split" in text and "cost-based cut: kept the structural split" in text
    assert "3 stages, 1 host boundary(ies)" in text and "host: MLUdf[1-op]" in text


@pytest.mark.parametrize("which", ["plain", "split"])
def test_dnn_program_that_fails_to_build_raises(hospital, split_case, which):
    """Coverage alone sends work to the host: a supported pipeline whose
    tree_gemm program the packer refuses (a non-finite leaf value) raises
    the packer's error under ``transform="dnn"``, whole or as a split's
    suffix, and is not lowered to a host MLUdf."""
    pipes, _ = split_case
    pipe = pipes[which][1]
    nodes = []
    for n in pipe.nodes:
        if n.op == "tree_ensemble":
            ens = n.attrs["ensemble"]
            leaf = ens.leaf_value.copy()
            leaf[np.flatnonzero(ens.feature < 0)[0]] = np.inf
            ens = dataclasses.replace(ens, leaf_value=leaf)
            n = dataclasses.replace(n, attrs={**n.attrs, "ensemble": ens})
        nodes.append(n)
    db = raven.connect(hospital.tables, device="cpu")
    db.register_model("m", dataclasses.replace(pipe, nodes=nodes))
    with pytest.raises(ValueError, match="is not finite"):
        db.sql(QUERY).prepare(transform="dnn", params={"t": 0.5})


@pytest.mark.parametrize("transform,which", [("none", "plain"), (None, "plain"),
                                             ("dnn", "split"), ("none", "split")])
def test_host_runtime_queries_match_reference(hospital, split_case, transform, which):
    pipes, scores = split_case
    ref_db, db = _sessions(hospital.tables, *pipes[which])
    asthma = hospital.joined_columns()["asthma"] == 1
    thresholds = [_gap_threshold(scores[which], asthma, q) for q in (0.3, 0.7)]
    prep = db.sql(QUERY).prepare(transform=transform, params={"t": thresholds[0]})
    ref_prep = ref_db.sql(QUERY).prepare(transform=transform, params={"t": thresholds[0]})
    assert prep.report.transforms == ref_prep.report.transforms
    assert prep.report.placement == ref_prep.report.placement
    assert [s.kind for s in prep.compiled.stages] == [
        s.kind for s in ref_prep.compiled.graph.stages]
    assert "host" in [s.kind for s in prep.compiled.stages]
    for t in thresholds:
        got, want = prep.bind(t=t)(), ref_prep.bind(t=t)()
        assert sorted(got) == sorted(want) == ["count_rows", "mean_score"]
        assert got["count_rows"][0] == ((scores[which] >= t) & asthma).sum() > 0
        assert np.array_equal(got["count_rows"], np.asarray(want["count_rows"]))
        np.testing.assert_allclose(got["mean_score"], np.asarray(want["mean_score"]),
                                   rtol=1e-5)


def test_host_runtime_outputs_take_the_references_dtypes(hospital, split_case):
    """The interpreter's float64 scores and int64 labels are uploaded as
    float32 and int32, as the reference's ``jnp.asarray`` uploads them."""
    pipes, _ = split_case
    ref_db, db = _sessions(hospital.tables, *pipes["plain"])
    text = "SELECT * FROM PREDICT(model='m', data=patients) AS p WHERE age > :a"
    got = db.sql(text).prepare(params={"a": 60.0})()
    want = ref_db.sql(text).prepare(params={"a": 60.0})()
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k  # one interpreter: the same values


def test_split_query_with_no_row_left_at_the_boundary(hospital, split_case):
    pipes, _ = split_case
    ref_db, db = _sessions(hospital.tables, *pipes["split"])
    text = QUERY.replace("score >= :t", "age > :t")
    got = db.sql(text).prepare(transform="dnn", params={"t": 1e9})()
    want = ref_db.sql(text).prepare(transform="dnn", params={"t": 1e9})()
    assert got["count_rows"].tolist() == np.asarray(want["count_rows"]).tolist() == [0.0]
    assert np.array_equal(got["mean_score"], np.asarray(want["mean_score"]))


def test_cost_model_calibrates_from_a_split_graph(hospital, split_case):
    pipes, _ = split_case
    db = raven.connect(hospital.tables, device="cpu")
    db.register_model("m", pipes["split"][1])
    prep = db.table("patients").predict("m").prepare(transform="dnn")
    prep()
    model = CostModel()
    before = dict(model.host_ns)
    # the host stage is observed (the reference's rule: a pure stage counts
    # only where its operators carry their pipeline, which TensorOps do not)
    assert model.calibrate_from_graph(prep.compiled.graph, rows=2048) == 1
    assert model.host_ns["python_udf"] != before["python_udf"]
