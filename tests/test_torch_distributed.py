"""The port's multi-device execution on ``torch.distributed`` against the
reference's under ``shard_map``.

The reference's values come from one child process on 8 host devices
(``XLA_FLAGS`` must precede JAX's start, as in ``tests/test_distributed.py``);
the port's from gloo ranks on the CPU, one set of processes a world size
(8, 4, 2 and 1), each running every case of its size
(``tests/torch_dist_cases.py``). All of them start together; each writes an
``.npz`` and this process compares.

* ``compile_plan_sharded`` at 8 ranks: the hospital query (2,048 rows, a
  decision tree) under ``sql`` and ``dnn`` and a star schema with a join
  and a filter. COUNT equals the reference's sharded COUNT and SUM is within
  rtol 1e-5 of its SUM (the same sums in another order); MIN and MAX are
  bitwise the unsharded plan's, in both packages, with a shard that has no
  row past the filter and with a NaN in one shard. The reference's sharded
  MIN and MAX are not: it ``psum``s them (printed and pinned). A plan with no
  aggregate gathers the reference's global table. MEAN and 2,047 rows are
  refused.
* ``hierarchical_psum`` on (pod 2, data 4) equals the reference's and one
  flat all-reduce bitwise (sums of small integers and halves), a leaf the
  intra axis does not divide included.
* ``compressed_gradient_update(axis_name="pod")`` on (pod 4,): the output
  and the new residual bitwise the reference's (the scales' MAX and the
  int32 payloads' SUM are exact in any order).
* the vocab-sharded ``embed_lookup`` on (data 2, model 4) at B = 4 and
  B = 1: bitwise ``take`` and the reference's; through ``Model.loss``,
  ``prefill`` and ``decode`` of reduced qwen2-0.5b and whisper-small,
  bitwise the port without a mesh and within 1e-5 of the reference's zoo
  on the same mesh.
* ``moe_ffn`` over 2 data ranks (``moe.sharded_batch``), at the config's
  capacity factor with assignments dropped: each rank's rows the
  reference's on the whole batch, where a rank counting capacity alone
  would keep what the reference drops.
* ``make_train_step(model, mesh)`` at 2 ranks (reduced qwen2-0.5b and
  qwen2-moe-a2.7b at their configs' settings, float32, labels below 0 on
  one rank only, the moe dropping assignments): the loss, the gradient
  norm and every parameter after one step against the reference's step on
  the whole batch; at 1 rank bitwise the step without a mesh.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as jreduced_config
from repro.ml.pipeline import save_pipeline
from repro.models import build_model as jbuild_model
from repro_torch.distributed import hierarchical_psum
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.relational import engine as E
from repro_torch.relational import expr as X
from tests import torch_dist_cases as C
from tests.conftest import train_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (8, 4, 2, 1)
TIMEOUT_S = 300
RTOL = 1e-5


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8) if a.dtype == np.bool_ else a.view(f"u{a.dtype.itemsize}")


def _bitwise(got, want, what) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert np.array_equal(_bits(got), _bits(want)), (what, got, want)


def _embed_inputs() -> tuple[np.ndarray, np.ndarray]:
    """``tests/test_distributed.py``'s table (V = 64, D = 16) and tokens
    (B = 4, S = 8)."""
    embed = jax.random.normal(jax.random.PRNGKey(0), (64, 16), np.float32)
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0, 64)
    return np.asarray(embed), np.asarray(toks)


@pytest.fixture(scope="module")
def runs(hospital, tmp_path_factory):
    """(the reference's results, the port's by world size and rank)."""
    d = str(tmp_path_factory.mktemp("dist"))
    save_pipeline(train_pipeline(hospital, "dt"), os.path.join(d, "m.npz"))
    np.savez(os.path.join(d, "patients.npz"), **hospital.tables["patients"])
    embed, toks = _embed_inputs()
    inputs = {
        "g": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 32), np.float32)),
        "embed": embed, "toks": toks,
    }
    for arch in C.PARAM_ARCHS:
        params = jbuild_model(C.train_config(jreduced_config, arch)).init(jax.random.PRNGKey(0))
        inputs.update({f"{arch}/{k}": v for k, v in
                       C.flat(jax.tree_util.tree_map(np.asarray, params)).items()})
    np.savez(os.path.join(d, "inputs.npz"), **inputs)

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref_env = dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={C.WORLD}")
    cmds = {"reference": (["reference", d], ref_env)}
    for w in WORLDS:
        for r in range(w):
            cmds[f"port_{w}_{r}"] = (["port", str(w), str(r), d], env)
    procs = {}
    for name, (args, e) in cmds.items():
        with open(os.path.join(d, f"{name}.log"), "w") as log:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "tests.torch_dist_cases", *args], cwd=REPO, env=e,
                stdout=log, stderr=subprocess.STDOUT)
    try:
        for p in procs.values():
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        with open(os.path.join(d, f"{name}.log")) as log:
            assert p.returncode == 0, (name, log.read()[-4000:])
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    ref.update({f"init/{k}": v for k, v in inputs.items() if "/" in k})
    port = {w: [dict(np.load(os.path.join(d, f"port_{w}_{r}.npz"))) for r in range(w)]
            for w in WORLDS}
    return ref, port


# ---------------------------------------------------------------------------
# compile_plan_sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tf", C.TRANSFORMS)
def test_sharded_hospital_count_and_sum_match_the_reference(runs, tf):
    ref, port = runs
    keys = sorted(k for k in ref if k.startswith(f"hosp/{tf}/sums/sharded/"))
    assert len(keys) == 2
    for rank, out in enumerate(port[8]):
        assert sorted(k for k in out if k.startswith(f"hosp/{tf}/sums/sharded/")) == keys
        for k in keys:
            got, want = out[k], ref[k]
            assert got.shape == want.shape == (1,), k
            if "count" in k:
                _bitwise(got, want, (rank, k))
                assert got[0] > 0
            else:
                np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=f"{rank} {k}")
            _bitwise(got, port[8][0][k], ("ranks agree", rank, k))


@pytest.mark.parametrize("tf", C.TRANSFORMS)
def test_sharded_min_and_max_equal_the_unsharded_plan(runs, tf, capsys):
    """Bitwise the port's ``compile_plan`` and the reference's
    ``execute_plan``; the reference's own sharded MIN and MAX are the
    ``psum`` of the shards' (its fault, pinned and printed)."""
    ref, port = runs
    prefix = f"hosp/{tf}/extremes/"
    keys = sorted(k[len(prefix) + len("sharded/"):] for k in ref
                  if k.startswith(prefix + "sharded/"))
    assert len(keys) == 2
    for k in keys:
        whole = ref[prefix + "whole/" + k]
        for rank, out in enumerate(port[8]):
            _bitwise(out[prefix + "sharded/" + k], out[prefix + "whole/" + k], (rank, k))
            _bitwise(out[prefix + "sharded/" + k], whole, (rank, k, "reference unsharded"))
        faulty = ref[prefix + "sharded/" + k]
        with capsys.disabled():
            print(f"\n{tf} {k}: port sharded {port[8][0][prefix + 'sharded/' + k]} = unsharded "
                  f"{whole}; reference sharded {faulty} ({faulty / whole} x)")
        assert not np.array_equal(faulty, whole), "the reference's sharded psum of an extreme"


@pytest.mark.parametrize("name,op", [(n, op) for n, op, _ in C.STAR_AGGS])
def test_sharded_star_schema_matches_the_reference(runs, name, op):
    """Join and filter over the fact rows, one shard without a row past
    the filter: COUNT and SUM the reference's sharded values (dyadic: exact
    in any order), MIN and MAX the unsharded plan's in both packages."""
    ref, port = runs
    for rank, out in enumerate(port[8]):
        got = out[f"star/sharded/{name}"]
        _bitwise(got, out[f"star/whole/{name}"], (rank, name, "port unsharded"))
        _bitwise(got, ref[f"star/whole/{name}"], (rank, name, "reference unsharded"))
        if op in ("count", "sum"):
            _bitwise(got, ref[f"star/sharded/{name}"], (rank, name, "reference sharded"))
        assert np.isfinite(got).all()


def test_the_star_schema_has_an_empty_shard_and_extremes_of_both_signs(runs):
    """The case the MIN/MAX reduction must get right: shard 5 holds no
    valid row (its 0.0 must not win) while the measures' extremes keep
    their signs."""
    tables = C.star_tables()
    per = C.FACT_ROWS // C.WORLD
    x = tables["f"]["x"]
    assert (x[C.EMPTY_SHARD * per:(C.EMPTY_SHARD + 1) * per] <= 0).all()
    out = runs[1][8][0]
    assert out["star/sharded/min_x"][0] > 0 and out["star/sharded/max_v1"][0] > 0
    assert out["star/sharded/min_v1"][0] < 0 and out["star/sharded/min_w"][0] < 0


@pytest.mark.parametrize("name,op", [(n, op) for n, op, _ in C.STAR_AGGS])
def test_a_nan_in_one_shard_comes_out_as_unsharded(runs, name, op):
    """A NaN in ``w`` of one shard's rows: MIN(w) and MAX(w) NaN, as the
    unsharded plan's in both packages, whatever the backend's MIN keeps;
    the rest bitwise the unsharded plan's."""
    ref, port = runs
    for rank, out in enumerate(port[8]):
        got, whole = out[f"star_nan/sharded/{name}"], out[f"star_nan/whole/{name}"]
        if name in ("min_w", "max_w"):
            assert np.isnan(got).all() and np.isnan(whole).all()
            assert np.isnan(ref[f"star_nan/whole/{name}"]).all()
        else:
            _bitwise(got, whole, (rank, name))
            _bitwise(got, ref[f"star_nan/whole/{name}"], (rank, name, "reference"))


def test_a_plan_without_aggregate_gathers_the_global_table(runs):
    """Every rank holds the reference's global ``valid`` and, on its valid
    rows, every column (a row the join missed carries no value)."""
    ref, port = runs
    keys = sorted(k for k in ref if k.startswith("star_rows/"))
    assert keys == ["star_rows/__valid__", "star_rows/fk", "star_rows/v0", "star_rows/v1",
                    "star_rows/w", "star_rows/x"]
    valid = ref["star_rows/__valid__"]
    assert valid.shape == (C.FACT_ROWS,) and 0 < valid.sum() < C.FACT_ROWS
    for rank, out in enumerate(port[8]):
        assert sorted(k for k in out if k.startswith("star_rows/")) == keys
        _bitwise(out["star_rows/__valid__"], valid, (rank, "valid"))
        for k in keys:
            assert out[k].shape == ref[k].shape, k
            _bitwise(out[k][valid], ref[k][valid], (rank, k))


def test_a_mean_is_refused():
    plan = E.Aggregate(C.star_plan(E, X, False), [("n", "count", "x"), ("avg_x", "mean", "x")])
    with pytest.raises(ValueError, match=r"cannot reduce the mean \['avg_x'\]: ask for SUM "
                                         r"and COUNT and divide"):
        E.compile_plan_sharded(plan, None, "f")


def test_a_fact_table_that_does_not_split_is_refused(runs):
    for out in runs[1][8]:
        assert str(out["refused/rows"]) == (
            "'patients' has 2047 rows, which do not split over the 8 ranks of axis 'data'")


def test_a_plan_with_a_host_boundary_is_refused(hospital, tmp_path):
    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
    from repro_torch.ml.pipeline import load_pipeline
    from repro_torch.sql.parser import parse_prediction_query

    path = str(tmp_path / "m.npz")
    save_pipeline(train_pipeline(hospital, "dt"), path)
    db = {"patients": hospital.tables["patients"]}
    plan, _ = RavenOptimizer(options=OptimizerOptions(transform="none")).optimize(
        parse_prediction_query(C.HOSPITAL_QUERIES["sums"], {"m": load_pipeline(path)}, db))
    with pytest.raises(ValueError, match="requires a host-boundary-free plan"):
        E.compile_plan_sharded(plan, None, "patients")


# ---------------------------------------------------------------------------
# Collectives, the int8 all-reduce and the vocab-sharded lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leaf", ["x", "y"])
def test_hierarchical_psum_matches_the_reference_and_a_flat_all_reduce(runs, leaf):
    ref, port = runs
    assert ref[f"hier/{leaf}"].shape[0] == C.WORLD
    _bitwise(ref[f"hier/{leaf}"], ref[f"hier_flat/{leaf}"], "reference")
    for rank, out in enumerate(port[8]):
        _bitwise(out[f"hier/{leaf}"], ref[f"hier/{leaf}"][rank:rank + 1], (rank, leaf))
        _bitwise(out[f"hier/{leaf}"], out[f"hier_flat/{leaf}"], (rank, leaf, "flat"))


def test_hierarchical_psum_without_the_intra_axis_returns_its_input(runs):
    tree = {"a": np.zeros(3)}
    assert hierarchical_psum(tree) is tree and hierarchical_psum(tree, None) is tree
    assert all(bool(out["hier/no_intra_axis"]) for out in runs[1][8])


@pytest.mark.parametrize("what", ["out", "residual"])
def test_compressed_all_reduce_is_bitwise_the_reference_s(runs, what):
    ref, port = runs
    want = ref[f"compressed/{what}"]
    assert want.shape == (4, 32)
    for rank, out in enumerate(port[4]):
        _bitwise(out[f"compressed/{what}"], want[rank:rank + 1], (rank, what))


@pytest.mark.parametrize("b", [4, 1])
def test_vocab_sharded_embed_lookup_matches_take_and_the_reference(runs, b):
    """B = 4 splits over the data axis; B = 1 (the long-context decode
    cells) stays whole on every rank."""
    ref, port = runs
    embed, toks = _embed_inputs()
    want = np.take(embed, toks[:b], axis=0)
    _bitwise(ref[f"embed/b{b}"], want, "reference")
    for rank, out in enumerate(port[8]):
        _bitwise(out[f"embed/b{b}"], want, (rank, b))


def test_the_vocab_sharded_lookup_refuses_a_gradient(runs):
    for out in runs[1][8]:
        assert str(out["refused/embed_grad"]).startswith(
            "the vocab-sharded lookup has no backward")


@pytest.mark.parametrize("part", ["loss", "prefill", "decode"])
@pytest.mark.parametrize("arch", C.MESH_ARCHS)
def test_the_model_on_a_vocab_sharded_mesh_matches_the_reference_s(runs, arch, part):
    """``Model.loss`` (no gradient), ``prefill`` and one ``decode`` step
    with ``mesh`` = (data 2, model 4) on every rank: bitwise the same calls
    without a mesh, and within 1e-5 of the reference's zoo on that mesh."""
    ref, port = runs
    pre = f"serve/{arch}/"
    keys = sorted(k[len(pre):] for k in ref if k.startswith(pre + part))
    assert keys and (part == "loss") == (keys == ["loss"])
    for rank, out in enumerate(port[8]):
        for k in keys:
            got = out[f"{pre}mesh/{k}"]
            _bitwise(got, out[f"{pre}none/{k}"], (rank, arch, k))
            assert got.shape == ref[pre + k].shape, (arch, k)
            np.testing.assert_allclose(got.astype(np.float32), ref[pre + k].astype(np.float32),
                                       rtol=RTOL, atol=1e-5, err_msg=f"{rank} {arch} {k}")


# ---------------------------------------------------------------------------
# moe_ffn over data ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_over_two_ranks_drops_what_the_reference_drops(runs, dispatch):
    """The reference drops assignments at the config's capacity factor
    (its output differs from the one with room for all); each rank's rows
    are the reference's, and differ from a rank that counts capacity over
    its own rows alone."""
    ref, port = runs
    want, roomy = ref[f"moe/{dispatch}"], ref[f"moe_roomy/{dispatch}"]
    assert np.abs(want - roomy).max() > 1e-2
    rows = C.MOE_ROWS // 2
    alone = []
    for rank, out in enumerate(port[2]):
        mine = want[rank * rows:(rank + 1) * rows]
        np.testing.assert_allclose(out[f"moe/{dispatch}"], mine, rtol=RTOL, atol=1e-6,
                                   err_msg=f"{rank}")
        alone.append(np.abs(out[f"moe_alone/{dispatch}"] - mine).max())
    assert max(alone) > 1e-2, alone


def test_a_moe_input_that_is_not_a_rank_s_slice_is_refused(runs):
    for out in runs[1][2]:
        assert str(out["refused/moe_rows"]) == (
            "a slice of 2 rows is not one of 2 equal slices of the 6 rows the step shards")


def test_the_data_parallel_moe_step_drops_assignments(runs):
    """At the config's own capacity factor (``ArchConfig``'s 1.25) the
    step below drops (token, k) assignments, so its match with the
    reference covers the drops."""
    cfg = C.train_config(jreduced_config, "qwen2-moe-a2.7b")
    assert cfg.moe_capacity_factor == 1.25
    assert sum(int(out["dropped/qwen2-moe-a2.7b"]) for out in runs[1][2]) > 0


# ---------------------------------------------------------------------------
# The mesh and the data-parallel step
# ---------------------------------------------------------------------------


def test_the_production_mesh_names_the_world_size_it_needs(runs):
    for out in runs[1][8]:
        assert str(out["refused/production"]) == (
            "a mesh of shape (16, 16) needs a world size of 256; the process group has 8")
    assert str(runs[1][1][0]["refused/production"]) == (
        "a mesh of shape (2, 16, 16) needs a world size of 512; the process group has 1")


def test_a_mesh_needs_an_initialized_group():
    with pytest.raises(RuntimeError, match="init_process_group\\('gloo'"):
        make_local_mesh(device="cpu")


@pytest.mark.parametrize("arch", C.ARCHS)
def test_data_parallel_step_matches_the_reference_on_the_whole_batch(runs, arch):
    """The loss and the gradient norm within rtol 1e-5; the summed
    gradient, read as AdamW's first moment after one step from zero
    ((1 - b1) g), within 1e-5 of each leaf's largest element; the
    parameters within 1e-2 of how far the reference moved them, the
    criterion of ``tests/test_torch_train.py``: AdamW's first step moves
    each element by about lr times the sign of its gradient, so an element
    whose gradient is float32 noise moves by up to lr either way, in the
    port's step without a mesh as in this one."""
    ref, port = runs
    pre = f"train/{arch}/"
    params = sorted(k for k in ref if k.startswith(pre + "params/"))
    moments = sorted(k for k in ref if k.startswith(pre + "m/"))
    assert params and len(moments) == len(params)
    for rank, out in enumerate(port[2]):
        assert sorted(k for k in out if k.startswith(pre + "params/")) == params
        for k in (pre + "loss", pre + "grad_norm"):
            np.testing.assert_allclose(out[k], ref[k], rtol=RTOL, err_msg=f"{rank} {k}")
        for k in moments:
            scale = float(np.abs(ref[k]).max())
            assert scale > 0, k
            assert float(np.abs(out[k] - ref[k]).max()) <= RTOL * scale, (rank, k)
        for k in params:
            start = ref[f"init/{arch}/{k[len(pre + 'params/'):]}"]
            moved = np.linalg.norm(ref[k] - start)
            assert moved > 0, k
            assert np.linalg.norm(out[k] - ref[k]) <= 1e-2 * moved, (rank, k)
        for k in out:
            if k.startswith(pre):
                _bitwise(out[k], port[2][0][k], ("ranks agree", rank, k))


@pytest.mark.parametrize("arch", C.ARCHS)
def test_a_world_one_mesh_step_is_bitwise_the_step_without_one(runs, arch):
    out = runs[1][1][0]
    keys = sorted(k for k in out if k.startswith(f"train/{arch}/"))
    assert len(keys) > 2
    for k in keys:
        _bitwise(out[k.replace("train/", "train_mesh/")], out[k], k)
