"""The port's dry run and its sharded parameters against the reference.

* **Placements.** Every leaf of the parameters and the AdamW state of the
  ten full configs, every input of every arch × shape, on (16, 16) and
  (2, 16, 16): the port's ``Sharding`` has the reference's
  ``PartitionSpec`` (from ``shardings_for``/``batch_shardings`` on a JAX
  ``AbstractMesh``), and rank 0's local shape on a fake group of 256 or
  512 ranks is ``NamedSharding.shard_shape``; the inputs' names, order and
  dtypes and the decode caches' order are the reference's.
* **Numerics on four gloo ranks.** Reduced qwen2-0.5b at (data 2, model 2)
  and at (data 1, model 4) (2 KV heads over 4 ranks: the K/V repeated to
  the query heads), granite-3-8b (``act_shard="seq"``, 4 microbatches) and
  llava-next-34b (6 heads padded to 8 over 4 ranks, 8 microbatches), with
  parameters placed by ``shardings_for``: ``Model.loss``, ``prefill`` and
  one ``decode`` step against the reference's zoo within 4.8e-7 of the
  largest value; one ``make_train_step`` against the reference's step on
  the whole batch: the loss and the gradient norm within rtol 1e-5, AdamW's
  first moment within 1e-5 of each leaf's largest element, the parameters
  within 1e-2 of how far the reference moved them (the data-parallel
  step's standard in tests/test_torch_distributed.py).
* **The attention operators' sharding rules**: batch- and head-sharded
  DTensors give the plain call's values.
* **Restore**: the reference's checkpoint restored onto a (2, 2) mesh: each
  rank's shard is the global array's slice at its coordinate, bit for bit,
  and ``full_tensor()`` the reference's array, bf16 leaves included.
* **The cost analysis** on the reference's ``tests/test_hlo_analysis.py``
  programs, in torch: exact FLOPs, loops, the gradient; and one known
  redistribution's collective bytes.
* **The dry run** of the reduced dense and vlm configs on 256 fake ranks:
  ``ok``; ``arg_bytes`` the reference's per-device shard bytes of the same
  trees; ``model_flops``, ``n_params``, ``n_active_params``, ``n_tokens``
  the reference's formulas; ``exec_flops`` × 256 at least the unsharded
  step's FLOPs and at most those plus 15 × its attention's (the one
  replicated work: 16 model ranks hold every head where the reduced
  configs' heads do not divide 16; equal for a prefill and a decode step,
  whose attention has no backward to count by difference); a moe cell
  refused, a long_500k cell skipped.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, AxisType, NamedSharding

from repro.checkpoint.store import save_checkpoint as jsave_checkpoint
from repro.configs import ARCHS, get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.shardings import batch_shardings as jbatch_shardings
from repro.models import build_model as jbuild_model
from repro.models.base import SHAPES as JSHAPES
from repro.models.base import active_param_count as jactive_param_count
from repro.models.base import param_count as jparam_count
from repro.models.base import shardings_for as jshardings_for
from repro.models.base import struct as jstruct
from repro.models.zoo import decode_caches_from_specs as jdecode_caches
from repro.train.step import init_opt_state as jinit_opt_state
from repro.train.step import make_train_step as jmake_train_step
from tests import torch_dryrun_cases as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
RTOL = 1e-5
SERVE_TOL = 4.8e-7
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), REPO]),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _start(args, log: str):
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "tests.torch_dryrun_cases", *args],
                                cwd=REPO, env=_env(), stdout=f, stderr=subprocess.STDOUT)


def _wait(procs: dict, d: str) -> None:
    try:
        for p in procs.values():
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for name, p in procs.items():
        if p.returncode:
            with open(os.path.join(d, f"{name}.log")) as f:
                raise AssertionError(f"{name} exited {p.returncode}:\n{f.read()[-4000:]}")


def _abstract(tag: str):
    shape, names = MESHES[tag]
    return AbstractMesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))


def _jstructs(shapes, dtype=jnp.bfloat16):
    return jax.tree.map(lambda s: jstruct(s, dtype), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


def _paths(tree, prefix: str = "") -> dict:
    return C.flat(tree, prefix) if isinstance(tree, dict) else {prefix: tree}


def _reference_serve(name, arch, mesh_shape, B, S, params) -> dict:
    """The reference's loss, prefill, one decode step and one train step of
    a case, unsharded (sharding does not change the function)."""
    cfg = C.case_config(jreduced_config, arch)
    model = jbuild_model(cfg)
    nb = C.case_batch(cfg, B, S)
    batch = {k: jnp.asarray(v) for k, v in nb.items() if k != "next"}
    out = {f"{name}/loss": np.asarray(jax.jit(model.loss)(params, batch))}
    T = C.prompt_len(cfg, S)
    logits, caches = jax.jit(lambda p, b: model.prefill(p, b, cache_len=T + C.EXTRA))(
        params, batch)
    out[f"{name}/prefill/logits"] = np.asarray(logits)
    for i, c in enumerate(caches):
        out[f"{name}/prefill/cache{i}"] = np.asarray(c)
    step = {"tokens": jnp.asarray(nb["next"]), "lengths": jnp.full((B,), T, jnp.int32)}
    logits, caches = jax.jit(model.decode)(params, step, caches)
    out[f"{name}/decode/logits"] = np.asarray(logits)
    for i, c in enumerate(caches):
        out[f"{name}/decode/cache{i}"] = np.asarray(c)
    opt = jinit_opt_state(model, params)
    p2, opt, metrics = jax.jit(jmake_train_step(model, lr=C.LR, accum_steps=cfg.accum_steps))(
        params, opt, batch)
    out[f"{name}/train/loss"] = np.asarray(metrics["loss"])
    out[f"{name}/train/grad_norm"] = np.asarray(metrics["grad_norm"])
    for part, tree in (("params", p2), ("m", opt["m"])):
        for k, v in C.flat(jax.tree.map(np.asarray, tree)).items():
            out[f"{name}/train/{part}/{k}"] = v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every child started at once: the placements, the reduced dry run
    and the four gloo ranks; the reference computed meanwhile. Returns
    (reference, inputs, placements, dry run, [rank outputs])."""
    d = str(tmp_path_factory.mktemp("dryrun"))
    inputs = {}
    for arch in dict.fromkeys(a for _, a, *_ in C.SERVE_CASES):
        params = jbuild_model(C.case_config(jreduced_config, arch)).init(jax.random.PRNGKey(0))
        inputs.update({f"{arch}/{k}": v for k, v in
                       C.flat(jax.tree.map(np.asarray, params)).items()})
    np.savez(os.path.join(d, "inputs.npz"), **inputs)
    tree = C.restore_tree()
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["layers"]["attn"]["wq_col"] = jnp.asarray(tree["layers"]["attn"]["wq_col"]).view(
        jnp.bfloat16)
    jsave_checkpoint(os.path.join(d, "ckpt"), 3, jtree)
    procs = {"placements": _start(["placements", os.path.join(d, "placements.json")],
                                  os.path.join(d, "placements.log")),
             "dryrun": _start(["dryrun", os.path.join(d, "dryrun.json")],
                              os.path.join(d, "dryrun.log"))}
    for r in range(C.WORLD):
        procs[f"rank_{r}"] = _start(["gloo", str(r), d], os.path.join(d, f"rank_{r}.log"))
    ref = {}
    try:
        for name, arch, shape, B, S in C.SERVE_CASES:
            if any(k.startswith(f"{name}/") for k in ref):
                continue
            params = jax.tree.map(jnp.asarray, C.nest(
                {k[len(arch) + 1:]: v for k, v in inputs.items() if k.startswith(arch + "/")}))
            ref.update(_reference_serve(name, arch, shape, B, S, params))
    finally:
        _wait(procs, d)
    with open(os.path.join(d, "placements.json")) as f:
        placed = json.load(f)
    with open(os.path.join(d, "dryrun.json")) as f:
        dry = json.load(f)
    ranks = [dict(np.load(os.path.join(d, f"rank_{r}.npz"))) for r in range(C.WORLD)]
    return ref, inputs, placed, dry, ranks, jtree


# ---------------------------------------------------------------------------
# placements of the full configs
# ---------------------------------------------------------------------------


def _check_tree(got: dict, jtree, jshard) -> None:
    want = _paths(jshard)
    shapes = _paths(jtree)
    assert sorted(got) == sorted(want)
    for path, sh in want.items():
        spec = [list(a) if isinstance(a, tuple) else a for a in tuple(sh.spec)]
        assert got[path]["spec"] == spec, (path, got[path]["spec"], spec)
        shard = list(sh.shard_shape(tuple(shapes[path].shape)))
        assert got[path]["shard"] == shard and got[path]["local"] == shard, (path, got[path], shard)


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_is_placed_as_the_reference_places_it(runs, arch, tag):
    """Parameters and AdamW state: spec, shard shape and rank 0's local
    shape, leaf by leaf."""
    placed, mesh = runs[2], _abstract(tag)
    model = jbuild_model(jget_config(arch))
    params = _jstructs(model.shapes)
    _check_tree(placed[f"{tag}/{arch}/params"], params, jshardings_for(params, mesh))
    opt = jinit_opt_state(model, params, materialize=False)
    _check_tree(placed[f"{tag}/{arch}/opt"], opt, jshardings_for(opt, mesh))


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_every_input_and_cache_is_placed_as_the_reference_places_it(runs, arch, tag):
    """Every shape's inputs: names, order, dtypes, specs and shard shapes;
    the decode caches in the reference's order."""
    placed, mesh = runs[2], _abstract(tag)
    model = jbuild_model(jget_config(arch))
    for name, sp in JSHAPES.items():
        specs = model.input_specs(sp)
        got = dict(placed[f"{tag}/{arch}/inputs/{name}"])
        assert got.pop("order") == list(specs)
        assert got.pop("dtypes") == {k: "torch." + str(v.dtype) for k, v in specs.items()}
        _check_tree(got, specs, jbatch_shardings(specs, mesh))
    sp = JSHAPES["decode_32k"]
    specs = model.input_specs(sp)
    names = placed[f"{tag}/{arch}/caches"]
    assert set(names) == set(specs) - {"tokens", "lengths"}
    assert [(specs[n].shape, specs[n].dtype) for n in names] == [
        (c.shape, c.dtype) for c in jdecode_caches(model, sp)]


def test_the_examples_of_the_rules(runs):
    """qwen2-0.5b on (16, 16): 8 columns of a 64-wide KV head a rank; the
    decode cache's sequence over ``model`` (2 KV heads do not divide 16)."""
    placed = runs[2]
    wk = placed["16x16/qwen2-0.5b/params"]["layers/attn/wk_col"]
    assert wk["spec"] == [None, "data", "model"] and wk["local"] == [24, 56, 8]
    kc = placed["16x16/qwen2-0.5b/inputs/decode_32k"]["k_cache"]
    assert kc["spec"] == [None, "data", "model", None, None]
    assert kc["placements"] == ["Shard(dim=1)", "Shard(dim=2)"]
    mp = placed["2x16x16/qwen2-0.5b/params"]["layers/attn/wk_col"]
    assert mp["placements"] == ["Shard(dim=1)", "Shard(dim=1)", "Shard(dim=2)"]


# ---------------------------------------------------------------------------
# numerics on four gloo ranks
# ---------------------------------------------------------------------------

CASES = [c[0] for c in C.SERVE_CASES]


@pytest.mark.parametrize("part", ["loss", "prefill", "decode"])
@pytest.mark.parametrize("name", CASES)
def test_sharded_serving_matches_the_reference(runs, name, part):
    ref, ranks = runs[0], runs[4]
    keys = sorted(k for k in ref if k.startswith(f"{name}/{part}"))
    assert keys
    for rank, out in enumerate(ranks):
        for k in keys:
            got, want = out[k], ref[k]
            assert got.shape == want.shape, (k, got.shape, want.shape)
            scale = max(1.0, float(np.abs(want).max()))
            err = float(np.abs(got.astype(np.float64) - want).max())
            assert err <= SERVE_TOL * scale, (rank, k, err)


def test_the_caches_keep_the_reference_s_layout(runs):
    """The prefill's caches as ``input_spec_for`` lays them: qwen2's 2 KV
    heads shard over (data 2, model 2)'s model axis by head; over (data 1,
    model 4) the sequence (2 heads do not divide 4)."""
    out = runs[4][0]
    assert str(out["qwen_2x2/prefill/placements0"]) == "(Shard(dim=1), Shard(dim=3))"
    assert str(out["qwen_1x4/prefill/placements0"]) == "(Shard(dim=1), Shard(dim=2))"


@pytest.mark.parametrize("name", CASES)
def test_sharded_train_step_matches_the_reference(runs, name):
    ref, inputs, ranks = runs[0], runs[1], runs[4]
    arch = dict((c[0], c[1]) for c in C.SERVE_CASES)[name]
    pre = f"{name}/train/"
    params = sorted(k for k in ref if k.startswith(pre + "params/"))
    moments = sorted(k for k in ref if k.startswith(pre + "m/"))
    assert params and len(moments) == len(params)
    for rank, out in enumerate(ranks):
        for k in (pre + "loss", pre + "grad_norm"):
            np.testing.assert_allclose(out[k], ref[k], rtol=RTOL, err_msg=f"{rank} {k}")
        for k in moments:
            scale = float(np.abs(ref[k]).max())
            assert scale > 0, k
            assert float(np.abs(out[k] - ref[k]).max()) <= RTOL * scale, (rank, k)
        for k in params:
            start = inputs[f"{arch}/{k[len(pre + 'params/'):]}"]
            moved = np.linalg.norm(ref[k] - start)
            assert moved > 0, k
            assert np.linalg.norm(out[k] - ref[k]) <= 1e-2 * moved, (rank, k)


@pytest.mark.parametrize("op", ["flash", "decode"])
def test_the_attention_operators_shard_by_batch_and_heads(runs, op):
    """Called on DTensors, the operators' sharding rules keep each input's
    batch or head shards (KV heads by whole groups) and give the plain
    call's values."""
    for out in runs[4]:
        want = out[f"ops/{op}/plain"]
        tags = ("batch", "heads", "both") if op == "flash" else ("batch", "heads")
        for tag in tags:
            np.testing.assert_allclose(out[f"ops/{op}/{tag}"], want, rtol=1e-6, atol=1e-6,
                                       err_msg=tag)
        assert str(out[f"ops/{op}/heads/placements"]) == (
            "(Replicate(), Shard(dim=2))" if op == "flash" else "(Replicate(), Shard(dim=1))")


def test_restore_onto_mesh_gives_each_rank_its_slice(runs):
    ranks, jtree = runs[4], runs[5]
    want = {k: np.asarray(v) for k, v in C.flat(jtree).items()}
    for out in ranks:
        assert int(out["restore/step"]) == 3
        for k, arr in want.items():
            bits = arr.view(np.int16) if arr.dtype == jnp.bfloat16 else arr
            assert str(out[f"restore/{k}/dtype"]) == (
                "torch.bfloat16" if arr.dtype == jnp.bfloat16 else f"torch.{arr.dtype}"), k
            # shapes first: assert_array_equal broadcasts a 0-d leaf
            assert out[f"restore/{k}/full"].shape == bits.shape, k
            np.testing.assert_array_equal(out[f"restore/{k}/full"], bits, err_msg=k)
            local = out[f"restore/{k}/local"]
            coord = out[f"restore/{k}/coordinate"]
            window = _window(arr.shape, str(out[f"restore/{k}/placements"]), coord)
            assert local.shape == bits[window].shape, k
            np.testing.assert_array_equal(local, bits[window], err_msg=k)


def _window(shape, placements: str, coord) -> tuple:
    """The global slice a rank at ``coord`` of a (2, 2) mesh holds."""
    window = [slice(None)] * len(shape)
    for mesh_dim, p in enumerate(placements.strip("()").split("), ")):
        if p.startswith("Shard"):
            dim = int(p.split("=")[1].rstrip(")"))
            n = shape[dim] // C.RESTORE_MESH[mesh_dim]
            window[dim] = slice(coord[mesh_dim] * n, (coord[mesh_dim] + 1) * n)
    return tuple(window)


# ---------------------------------------------------------------------------
# the cost analysis
# ---------------------------------------------------------------------------


def test_matmul_flops_exact_and_the_reference_s():
    import torch

    from repro_torch.launch.hlo_analysis import analyze

    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    got = analyze(lambda: a @ b)[1]
    assert got.flops == 2 * 64 * 32 * 128
    sa, sb = (jax.ShapeDtypeStruct(s, jnp.float32) for s in ((64, 128), (128, 32)))
    ref = analyze_hlo(jax.jit(lambda x, y: x @ y).lower(sa, sb).compile().as_text())
    assert got.flops == ref.flops
    assert got.unknown_trip_loops == 0


@pytest.mark.parametrize("loops", [(11,), (5, 3)])
def test_loops_count_every_iteration(loops):
    import torch

    from repro_torch.launch.hlo_analysis import analyze

    n = 32 if len(loops) == 1 else 16
    x = torch.zeros(n, n)

    def f(c):
        for _ in range(loops[0]):
            if len(loops) == 1:
                c = torch.tanh(c @ c)
            else:
                for _ in range(loops[1]):
                    c = c @ c
        return c

    assert analyze(f, x)[1].flops == int(np.prod(loops)) * 2 * n ** 3


def test_the_gradient_counts_twice_the_forward():
    import torch

    from repro_torch.launch.hlo_analysis import analyze

    w = torch.zeros(64, 64, requires_grad=True)
    x = torch.zeros(8, 64)
    fwd = analyze(lambda: torch.tanh(x @ w).sum())[1]
    both = analyze(lambda: torch.autograd.grad(torch.tanh(x @ w).sum(), w))[1]
    assert both.flops == 2 * fwd.flops


def test_a_known_redistribution_s_collective_bytes(runs):
    """(16, 8) float32 rows sharded over 4 ranks, gathered: 512 bytes of
    all-gather result on each; a sum's partial all-reduced: 4 bytes."""
    got = runs[3]["redistribute"]
    assert got == {"gather": {"all-gather": 512.0}, "sum": {"all-reduce": 4.0}}


def test_the_kernels_formulas_are_counted():
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops
    from repro_torch.launch.hlo_analysis import analyze

    with FakeTensorMode():
        q = torch.empty(2, 8, 4, 16, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(2, 8, 2, 16, device="cuda", dtype=torch.bfloat16)
        out, cost = analyze(ops.flash_attention_op, q, k, k, causal=True)
        with FlopCounterMode(display=False) as fc:
            ops.flash_attention_op(q, k, k, causal=True)
        assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "cuda"
        lengths = torch.empty(2, dtype=torch.int32, device="cuda")
        q1 = torch.empty(2, 4, 16, device="cuda", dtype=torch.bfloat16)
        dec = analyze(ops.decode_attention_op, q1, k, k, lengths)[1]
    assert cost.flops == fc.get_total_flops() == 4 * 2 * 4 * 16 * (8 * 9 // 2)
    assert dec.flops == 4 * 2 * 4 * 16 * 8
    assert ops.attention_pairs(4, 6, True, 2) == 8
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.flash_attention_op(*(torch.empty(1, 2, 2, 8, device="meta") for _ in range(3)))


# ---------------------------------------------------------------------------
# the dry run of the reduced configs
# ---------------------------------------------------------------------------


def _ref_cell(arch: str, kind: str, B: int, S: int):
    cfg = C.case_config(jreduced_config, arch)
    import dataclasses

    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    from repro.models.base import ShapeSpec

    return cfg, ShapeSpec(f"{kind}_{S}", kind, S, B)


def _shard_bytes(tree, shardings) -> int:
    total = 0
    for path, sh in _paths(shardings).items():
        leaf = _paths(tree)[path]
        total += int(np.prod(sh.shard_shape(tuple(leaf.shape)))) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a, k, _, _ in C.DRY_CELLS])
def test_the_reduced_dry_run_matches_the_reference_s_accounting(runs, cell):
    dry = runs[3]
    arch, kind = cell.split("/")
    B, S = next((b, s) for a, k, b, s in C.DRY_CELLS if (a, k) == (arch, kind))
    rec = dry[cell]
    assert rec["status"] == "ok", rec
    cfg, sp = _ref_cell(arch, kind, B, S)
    model = jbuild_model(cfg)
    mesh = _abstract("16x16")
    params = _jstructs(model.shapes)
    specs = model.input_specs(sp)
    want = _shard_bytes(params, jshardings_for(params, mesh))
    want += _shard_bytes(specs, jbatch_shardings(specs, mesh))
    if kind == "train":
        opt = jinit_opt_state(model, params, materialize=False)
        want += _shard_bytes(opt, jshardings_for(opt, mesh))
        assert rec["accum_scaled"] == cfg.accum_steps
    assert rec["arg_bytes"] == want
    n_tokens = B * (S if kind != "decode" else 1)
    assert rec["n_tokens"] == n_tokens
    assert rec["n_params"] == jparam_count(cfg)
    assert rec["n_active_params"] == jactive_param_count(cfg)
    mult = {"train": 6, "prefill": 2, "decode": 2}[kind]
    assert rec["model_flops"] == mult * jactive_param_count(cfg) * n_tokens
    assert rec["unknown_trip_loops"] == 0
    world, m = 256, 16
    u, a = rec["unsharded_flops"], rec["attention_flops"]
    assert u > 0 and a > 0
    total = rec["exec_flops"] * world
    assert u <= total <= u + (m - 1) * a, (total, u, a)
    if kind != "train":
        assert total == u + (m - 1) * a
    assert rec["exec_collective_bytes"], rec
    assert rec["temp_bytes"] > 0 and rec["out_bytes"] > 0


def test_a_moe_cell_is_refused_and_a_long_cell_skipped(runs):
    dry = runs[3]
    assert dry["moe"]["status"] == "refused"
    assert "ROADMAP" in dry["moe"]["reason"] and "moe" in dry["moe"]["reason"]
    assert dry["skipped"]["status"] == "skipped"


def test_gather_data_returns_a_plain_tree_itself():
    """Without DTensor leaves ``gather_data`` hands back the tree it was
    given, each dict of its own type (a layer's parameters keep any mark
    a caller put on them, as ``chip_smoke.py``'s planted faults do); with
    them it makes a new tree."""
    import torch

    from repro_torch.models import layers as L

    class Marked(dict):
        pass

    attn = Marked(wq_col=torch.ones(2, 2))
    tree = {"attn": attn, "ln1": torch.ones(2)}
    got = L.gather_data(tree)
    assert got is tree and type(got["attn"]) is Marked and got["attn"] is attn


def test_the_summary_tables_the_ok_records_and_counts_every_status(tmp_path):
    """``--summary`` reads the records in ``--out``: one row per ``ok``
    record (GiB per rank, executed FLOPs and collective bytes by kind), and
    every status counted."""
    from repro_torch.launch.dryrun import summary

    ok = {"arch": "qwen2-0.5b", "shape": "decode_32k", "status": "ok", "arg_bytes": 2**30,
          "temp_bytes": 2**29, "peak_bytes": 3 * 2**29, "exec_flops": 2.5e10,
          "exec_collective_bytes": {"all-gather": 2.0 * 2**30}, "trace_s": 1.5}
    for name, rec in (("qwen2-0.5b_decode_32k", ok),
                      ("arctic-480b_train_4k", {"arch": "arctic-480b", "status": "refused"})):
        (tmp_path / f"dryrun_sp_{name}.json").write_text(json.dumps(rec))
    lines = summary(str(tmp_path)).splitlines()
    assert lines[2] == ("| qwen2-0.5b | decode_32k | 1.000 | 0.500 | 1.500 | 2.5e+10 | "
                        "2.000 | 0.000 | 0.000 | 0.000 | 1 | 1.5 |")
    assert len(lines) == 5 and json.loads(lines[-1]) == {"ok": 1, "refused": 1}
