"""Capture (the port's ``jax.jit``) against the reference's jit accounting,
on the CPU.

On the card each pure stage is captured into one CUDA graph per input
structure; on the CPU the runner runs the stage eagerly and counts each new
structure once, so the same call sequence must count the same traces per
stage as the reference's ``jax.jit`` does: re-binding a ``:param``, a
repeated shape and a repeated segment-slot bucket add none; a new row count,
a padded spine, a new compacted host-boundary output and a new segment
bucket add one to each stage they reach. Results of the counted runs equal
the reference's (COUNT exactly, AVG within ``rtol=1e-5``: the two packages
sum in another order). Also here: the stage schema the serving layer reads,
the volatile keys and donation, the fault sites, the graph cache and the
launch tally a capture records, each as far as the CPU can show it; the
card-only parts are in ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro as jraven
import repro.ml as jml
import repro_torch as raven
from repro.data.datasets import make_hospital
from repro.errors import FaultInjectedError as RefFaultInjectedError
from repro.exec import faults as ref_faults
from repro.exec import stages as ref_stages
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.relational import engine as reng
from repro_torch.errors import FaultInjectedError
from repro_torch.exec import capture, faults, stages
from repro_torch.kernels import _build
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.relational import engine as teng

AGG = ("SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) AS p "
       "WHERE asthma = 1 AND score >= :t")
STAR = "SELECT * FROM PREDICT(model='m', data=patients) AS p WHERE score >= :t"
TRANSFORMS = ["dnn", "sql", "none"]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    ds = make_hospital(1200, seed=0)
    ref_pipe = jml.fit_pipeline(
        ds.joined_columns(), ds.label, ds.numeric, ds.categorical,
        jml.GradientBoostingClassifier(n_estimators=8, max_depth=3),
        categories=ds.categories(),
    )
    path = str(tmp_path_factory.mktemp("m") / "gb.npz")
    ref_save_pipeline(ref_pipe, path)
    return ds, ref_pipe, load_pipeline(path)


@pytest.fixture()
def sessions(model):
    ds, ref_pipe, port_pipe = model
    ref_db = jraven.connect(ds.tables, stats="auto")
    ref_db.register_model("m", ref_pipe)
    db = raven.connect(ds.tables, stats="auto", device="cpu")
    db.register_model("m", port_pipe)
    reng.clear_plan_cache()
    teng.clear_plan_cache()
    yield ref_db, db
    ref_db.close()
    db.close()


def _batch(n, seed):
    return make_hospital(n, seed=seed).tables["patients"]


def _padded(cols: dict, pad: int) -> dict:
    return {c: np.concatenate([v, np.zeros(pad, v.dtype)]) for c, v in cols.items()}


def _traces(cp) -> list[int]:
    return [st.traces for st in cp.stages]


def _assert_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        if w.dtype.kind == "f":
            np.testing.assert_allclose(np.asarray(got[k], np.float64), w, rtol=1e-5, atol=1e-6)
        else:
            assert np.array_equal(np.asarray(got[k]), w), k


def _call_sequence(ds):
    """(label, fact rows, row validity, :t, segments) of each call."""
    base = ds.tables["patients"]
    n = len(base["age"])
    small = _batch(300, seed=5)
    seg = (np.repeat(np.arange(3, dtype=np.int32), [100, 100, 100]), 3)
    return [
        ("first", base, None, 0.5, None),
        ("re-bound", base, None, 0.7, None),  # same shapes: nothing new
        ("new row count", small, None, 0.5, None),
        ("padded spine", _padded(base, 200), np.arange(n + 200) < n, 0.5, None),
        ("segmented", small, None, 0.5, seg),
        ("segmented again", small, None, 0.6, (seg[0], 4)),  # same slot bucket
        ("first again", base, None, 0.5, None),
    ]


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_trace_counts_match_the_reference_over_a_call_sequence(model, sessions, transform):
    ds = model[0]
    ref_db, db = sessions
    sql = AGG if transform != "none" else STAR
    rprep = ref_db.sql(sql).prepare(transform=transform, params={"t": 0.5})
    prep = db.sql(sql).prepare(transform=transform, params={"t": 0.5})
    assert [s.kind for s in prep.compiled.stages] == [s.kind for s in rprep.compiled.stages]
    rcp, cp = rprep.compiled, prep.compiled
    for label, fact, valid, t, segments in _call_sequence(ds):
        tables = {**ds.tables, "patients": fact}
        jdb = {tn: {c: jnp.asarray(v) for c, v in cols.items()} for tn, cols in tables.items()}
        want = rcp.run(jdb, row_valid=valid, params={"t": t}, segments=segments)
        got = cp.run(tables, row_valid=valid, params={"t": t}, segments=segments,
                     device="cpu")
        assert _traces(cp) == _traces(rcp), label
        _assert_close(got.table.to_numpy(), want.table.to_numpy())
    assert cp.traces == rcp.traces > 0
    assert teng.PLAN_CACHE_STATS.traces == reng.PLAN_CACHE_STATS.traces
    assert sorted(teng.PLAN_CACHE_STATS.stage_traces.values()) == sorted(
        reng.PLAN_CACHE_STATS.stage_traces.values())


def _dashboard(pkg):
    e = pkg.relational.engine
    x = pkg.relational.expr
    return e.Aggregate(
        e.Filter(e.Join(e.Scan("f", ["fk", "x"]), "d", "fk", "k", ["v"]),
                 x.Bin("gt", x.Col("x"), x.Const(0.0))),
        [("n", "count", "x"), ("s", "sum", "v"), ("lo", "min", "v"), ("hi", "max", "x")])


def test_dashboard_trace_counts_and_results_match_the_reference():
    """Filter→join→aggregate, global and segmented: the same traces per call
    and bitwise the same folds (dyadic values: exact in any order)."""
    import repro
    import repro_torch

    rng = np.random.default_rng(3)

    def tables(n):
        return {"d": {"k": np.arange(200, dtype=np.int64),
                      "v": (rng.integers(-40, 40, 200) * 0.25).astype(np.float32)},
                "f": {"fk": rng.integers(0, 250, n).astype(np.int64),
                      "x": (rng.integers(-40, 40, n) * 0.25).astype(np.float32)}}

    rcp = reng.compile_plan(_dashboard(repro), cache=False)
    cp = teng.compile_plan(_dashboard(repro_torch), cache=False)
    t1, t2 = tables(5000), tables(3000)
    calls = [(t1, None), (t1, None), (t2, None), (t1, (np.sort(rng.integers(0, 5, 5000)), 5)),
             (t1, (np.sort(rng.integers(0, 7, 5000)), 7)), (t2, (np.zeros(3000, np.int32), 2))]
    for tab, segments in calls:
        jdb = {tn: {c: jnp.asarray(v) for c, v in cols.items()} for tn, cols in tab.items()}
        want = rcp.run(jdb, segments=segments).table.to_numpy()
        got = cp.run(tab, segments=segments, device="cpu").table.to_numpy()
        assert _traces(cp) == _traces(rcp)
        assert sorted(got) == sorted(want)
        for k in want:
            assert np.array_equal(np.asarray(got[k], np.float32).view(np.uint32),
                                  np.asarray(want[k], np.float32).view(np.uint32)), k
    assert cp.traces == rcp.traces == 4  # 5000 rows, 3000 rows, 8 and 2 slots


@pytest.mark.parametrize("transform", TRANSFORMS)
def test_stage_schema_matches_the_reference(sessions, transform):
    """The tables and columns each stage reads and its :param slots: what the
    capture reads as a stage's resident inputs, and the serving layer's
    schema."""
    ref_db, db = sessions
    rprep = ref_db.sql(AGG).prepare(transform=transform, params={"t": 0.5})
    prep = db.sql(AGG).prepare(transform=transform, params={"t": 0.5})
    for st, rst in zip(prep.compiled.stages, rprep.compiled.stages):
        assert st.kind == rst.kind
        if st.kind == "pure":
            assert st.reads == rst.reads and st.params == rst.params
            assert st.runner is not None


def test_disabled_runs_eagerly_and_counts_nothing(sessions):
    _, db = sessions
    prep = db.sql(AGG).prepare(transform="dnn", params={"t": 0.5})
    with capture.disabled():
        assert not capture.enabled()
        off = prep()
    assert capture.enabled()
    assert prep.compiled.traces == 0
    on = prep()
    assert prep.compiled.traces == 1
    for k in on:
        assert np.array_equal(on[k], off[k])


def test_volatile_keys_and_donation_as_the_reference(monkeypatch):
    """The port's per-call keys include the reference's; donation is off on
    the CPU and on on the card unless ``RAVEN_DONATE`` forces it; once on,
    the entry stage's consumed inputs are dropped as the reference drops
    them."""
    assert set(ref_stages.VOLATILE_KEYS) <= set(stages.VOLATILE_KEYS)
    monkeypatch.delenv("RAVEN_DONATE", raising=False)
    assert not stages.donation_enabled("cpu")
    assert stages.donation_enabled(torch.device("cuda", 0))
    env = {"patients": {"a": torch.zeros(3)}, "other": {"b": torch.zeros(2)},
           stages.ROW_VALID_KEY: torch.ones(3, dtype=torch.bool),
           stages.ROW_SEG_KEY: torch.zeros(3, dtype=torch.int32),
           stages.PARAMS_KEY: {"t": torch.tensor(0.5)}}
    assert stages.strip_consumed(env, frozenset({"patients"})) is env
    monkeypatch.setenv("RAVEN_DONATE", "1")
    assert ref_stages.donation_enabled() and stages.donation_enabled("cpu")
    kept = stages.strip_consumed(env, frozenset({"patients"}))
    ref_kept = ref_stages.strip_consumed(dict.fromkeys(env), frozenset({"patients"}))
    assert sorted(kept) == sorted(ref_kept) == ["__params__", "other"]
    assert stages.strip_consumed(env, frozenset()) is env


def test_keys_leave_out_the_join_cache_and_split_per_call_inputs():
    """A dimsort entry's payload cache is no input: building it changes no
    key. The resident key names where the tables a stage reads lie, and
    leaves out its per-call inputs and the tables it does not read."""
    entry = teng.dimsort_entry(np.arange(8, dtype=np.int32), "cpu")
    env = {"f": {"x": torch.zeros(5), "y": torch.zeros(5)}, "d": {"k": torch.arange(8)},
           stages.DIMSORT_KEY: {"d": entry}, stages.PARAMS_KEY: {"t": torch.tensor(1.0)}}
    key = capture.env_key(env)
    entry[stages.DIMSORT_CACHE] = {("v",): (torch.zeros(8, 1), None)}
    assert capture.env_key(env) == key
    env2 = {**env, stages.PARAMS_KEY: {"t": torch.tensor(2.0)}}
    assert capture.env_key(env2) == key  # a value is not a shape
    env3 = {**env, "f": {"x": torch.zeros(6), "y": torch.zeros(6)}}
    assert capture.env_key(env3) != key
    reads = {"f": ("x",), "d": ("k",)}
    vol = frozenset(stages.VOLATILE_KEYS)
    res = capture.resident_key(env, reads, vol)
    assert [p for p, *_ in res] == [("f", "x"), ("d", "k"), (stages.DIMSORT_KEY, "d", "keys"),
                                    (stages.DIMSORT_KEY, "d", "order"),
                                    (stages.DIMSORT_KEY, "d", "unique")]
    assert capture.resident_key(env, reads, vol | {"f"})[0][0] == ("d", "k")
    assert capture.resident_key(env2, reads, vol) == res  # new params: same graph


@pytest.mark.parametrize("site", ["compile", "stage"])
def test_fault_sites_raise_as_in_the_reference(sessions, site):
    """A ``compile`` fault fires where a specialization is made and leaves
    it uncounted, so the next call makes it; a ``stage`` fault fires on any
    call. Both packages, the same call sequence, the same counts."""
    ref_db, db = sessions
    rprep = ref_db.sql(AGG).prepare(transform="sql", params={"t": 0.5})
    prep = db.sql(AGG).prepare(transform="sql", params={"t": 0.5})
    for p, fmod, err in ((rprep, ref_faults, RefFaultInjectedError),
                         (prep, faults, FaultInjectedError)):
        prev = fmod.set_fault_plan(fmod.FaultPlan({site: {"times": 1, "transient": False}}))
        try:
            with pytest.raises(err):
                p()
            assert p.compiled.traces == 0
            p()
            assert p.compiled.traces == 1
            assert fmod.get_fault_plan().injected() == {site: 1}
        finally:
            fmod.set_fault_plan(prev)


def test_udf_fault_site_fires_at_the_host_boundary(sessions):
    _, db = sessions
    prep = db.sql(AGG).prepare(transform="none", params={"t": 0.5})
    prev = faults.set_fault_plan(faults.FaultPlan({"udf": {"times": 1, "transient": False}}))
    try:
        with pytest.raises(FaultInjectedError):
            prep()
        prep()
    finally:
        faults.set_fault_plan(prev)
    assert [st.traces for st in prep.compiled.stages] == [1, 0, 1]


def test_a_recording_tallies_launches_instead_of_counting_them():
    """Inside a capture nothing runs: launches go into the graph's tally,
    which each replay adds to the counts."""
    before = dict(_build.LAUNCHES)
    tally: dict = {}
    with _build.recording(tally):
        _build.launched("segment_agg")
        _build.launched("featurize", 2)
    assert _build.LAUNCHES == before and tally == {"segment_agg": 1, "featurize": 2}
    _build.launched("segment_agg", tally["segment_agg"])
    assert _build.LAUNCHES["segment_agg"] == before["segment_agg"] + 1
    _build.LAUNCHES["segment_agg"] = before["segment_agg"]


class _Graph:
    nbytes = 10


class _Owner:
    pass


def test_graph_cache_is_bounded_and_drops_a_collected_owners_graphs():
    capture.clear()
    try:
        owner = _Owner()
        serial = capture.new_owner(owner)
        evicted = capture.evictions()
        for i in range(capture.GRAPH_CAPACITY + 6):
            capture.insert((serial, i), _Graph())
        assert capture.held() == (capture.GRAPH_CAPACITY, 10 * capture.GRAPH_CAPACITY)
        assert capture.evictions() == evicted + 6
        assert capture.lookup((serial, 0)) is None  # least recently used: gone
        assert capture.lookup((serial, 6)) is not None
        other = _Owner()
        capture.insert((capture.new_owner(other), 0), _Graph())
        del owner
        gc.collect()
        assert capture.held() == (1, 10)
    finally:
        capture.clear()


def test_capture_guards_are_inert_off_a_capture(sessions):
    """The CPU never captures: a constant's first copy, a lengths check and
    a join's payload build run as before."""
    from repro_torch.device import capturing
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.relational.expr import Bin, Col, Const, eval_expr

    assert not capturing()
    x = torch.arange(6, dtype=torch.float32)
    assert eval_expr(Bin("gt", Col("x"), Const(2.0)), {"x": x}, consts={}).sum() == 3
    q = torch.zeros((1, 2, 8))
    kc = torch.zeros((1, 4, 1, 8))
    assert decode_attention_ref(q, kc, kc, torch.tensor([2]), scale=1.0).shape == (1, 2, 8)


def test_engine_ticks_run_eagerly_on_the_cpu():
    """The decode tick is captured on the card only: on the CPU an engine
    captures nothing and serves the tokens it serves under ``disabled()``."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = reduced_config("qwen2-0.5b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    outs = []
    for off in (False, True):
        eng = ServeEngine(model, params, n_slots=2, cache_len=48, device="cpu")
        for n in (5, 11, 3):
            eng.submit(list(range(1, n + 1)), max_new_tokens=3)
        if off:
            with capture.disabled():
                done = eng.run()
        else:
            done = eng.run()
        assert eng.captures == eng.replays == 0
        outs.append([r.output for r in sorted(done, key=lambda r: r.rid)])
    assert outs[0] == outs[1]
