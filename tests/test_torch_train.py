"""The port's training path against the JAX package's on the same inputs.

Reduced configs in float32, the reference's weights carried over with
``params_from_jax``, batches drawn from a seeded numpy generator. Stated
tolerances: the loss within rtol 1e-5 of the reference's; each gradient
leaf within 1e-4 of that leaf's largest |g| in the reference (scaled, so a
leaf of small gradients is held as tightly as a large one); the
optimizers within float32 rounding (rtol 2e-6), bf16 moments within one
bf16 step of their value (rtol 2^-8); the loader, the int8 compression
and the checkpoints bit for bit.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.checkpoint import restore_onto_mesh, save_checkpoint as jsave_checkpoint
from repro.data.loader import TokenLoader as JTokenLoader
from repro.distributed import StragglerMonitor as JStragglerMonitor
from repro.distributed import compressed_gradient_update as jcompressed_update
from repro.distributed import ef_init as jef_init
from repro.models import layers as JL
from repro.train.optimizer import adafactor_init as jadafactor_init
from repro.train.optimizer import adafactor_update as jadafactor_update
from repro.train.optimizer import adamw_init as jadamw_init
from repro.train.optimizer import adamw_update as jadamw_update
from repro.train.step import init_opt_state as jinit_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    restore_onto_device,
    save_checkpoint,
)
from repro_torch.data.loader import TokenLoader
from repro_torch.distributed import StragglerMonitor, compressed_gradient_update, ef_init
from repro_torch.models import layers as L
from repro_torch.train.optimizer import (
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
)
from repro_torch.train.step import init_opt_state, loss_and_grads, make_train_step
from torch_zoo_pair import pair_of_models

LOSS_RTOL = 1e-5
GRAD_SCALE_TOL = 1e-4  # of the leaf's largest |g| in the reference
F32_RTOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """These small shapes run in tens of ms on two threads; on every core
    of a machine that the test workers share, the threads wait on each
    other (seconds a call)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _paths(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p, v


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _lm_batch(cfg, B: int, S: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, :3] = -1  # ignored
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision":
        batch["patches"] = (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
                            * 0.1).astype(np.float32)
    return batch


def _grads_close(grads, jgrads) -> None:
    for path, want in _paths(jax.tree_util.tree_map(np.asarray, jgrads)):
        got = _np(_get(grads, path))
        scale = float(np.abs(want).max())
        assert got.shape == want.shape, path
        err = float(np.abs(got - want).max())
        assert err <= GRAD_SCALE_TOL * scale, (path, err, scale)


# ---------------------------------------------------------------------------
# Layers: the training attention and the chunked loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,Sq,Skv,H,KH", [
    (True, 0, 200, 200, 4, 2),     # ragged in both chunks; blocks past the diagonal skipped
    (True, 72, 200, 200, 4, 4),    # a window: blocks before it skipped
    (False, 0, 70, 200, 6, 2),     # cross-style, G = 3
])
def test_attention_train_matches_reference_and_its_gradient(causal, window, Sq, Skv, H, KH):
    rng = np.random.default_rng(3)
    D = 16
    q = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((2, Skv, KH, D)).astype(np.float32)
    v = rng.standard_normal((2, Skv, KH, D)).astype(np.float32)
    dy = rng.standard_normal((2, Sq, H, D)).astype(np.float32)
    off = Skv - Sq if causal else 0
    kw = dict(causal=causal, window=window, q_chunk=64, k_chunk=128, q_offset=off)
    want, wgrads = jax.jit(lambda a, b, c, d: (lambda o, f: (o, f(d)))(
        *jax.vjp(lambda x, y, z: JL.attention_chunked(x, y, z, **kw), a, b, c)))(q, k, v, dy)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = L.attention_train(tq, tk, tv, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=2e-5)
    got.backward(torch.tensor(dy))
    for t, w in zip((tq, tk, tv), wgrads):
        w = np.asarray(w)
        assert np.abs(_np(t.grad) - w).max() <= GRAD_SCALE_TOL * np.abs(w).max()


@pytest.mark.parametrize("S,vocab_size", [(600, 100), (512, None)])
def test_xent_loss_chunked_matches_reference_and_its_gradient(S, vocab_size):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 128)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab_size or 128, (2, S)).astype(np.int32)
    labels[0, ::7] = -1
    f = lambda a, b: JL.xent_loss_chunked(a, b, jnp.asarray(labels), vocab_size=vocab_size)  # noqa
    want, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(x, w)
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = L.xent_loss_chunked(tx, tw, torch.tensor(labels), vocab_size=vocab_size)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    got.backward()
    for t, g in ((tx, gx), (tw, gw)):
        g = np.asarray(g)
        assert np.abs(_np(t.grad) - g).max() <= GRAD_SCALE_TOL * np.abs(g).max()


# ---------------------------------------------------------------------------
# Model.loss and its gradient: dense, moe (both dispatches, drops), vlm
# ---------------------------------------------------------------------------

LOSS_CASES = {  # remat on in dense, moe-einsum and vlm, off in moe-scatter
    "dense-S520-remat": ("qwen2-0.5b", {"remat": True}, 520),  # ragged in the 512, 1024 chunks
    "moe-einsum-drops": ("qwen2-moe-a2.7b", {"moe_capacity_factor": 0.5, "remat": True}, 32),
    "moe-scatter-drops": ("qwen2-moe-a2.7b", {"moe_dispatch": "scatter",
                                              "moe_capacity_factor": 0.5}, 32),
    "vlm-remat": ("llava-next-34b", {"remat": True}, 40),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_model_loss_and_gradients_match_reference(case):
    name, replace, S = LOSS_CASES[case]
    jmodel, jparams, model, params = pair_of_models(name, **replace)
    batch = _lm_batch(model.cfg, 1 if S > 512 else 2, S)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(model.loss, params, {k: torch.tensor(v)
                                                      for k, v in batch.items()})
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _grads_close(grads, jgrads)
    assert not any(p.requires_grad for _, p in _paths(params))


def test_moe_dropped_assignments_get_no_gradient():
    """With a capacity of 4 slots an expert, most (token, k) are dropped:
    the expert weights see only the kept tokens, and the scatter variant's
    trash slot E·C leaks nothing: both variants' gradients are equal."""
    grads = {}
    for dispatch in ("einsum", "scatter"):
        _, _, model, params = pair_of_models("qwen2-moe-a2.7b", moe_dispatch=dispatch,
                                             moe_capacity_factor=0.05)
        batch = {k: torch.tensor(v) for k, v in _lm_batch(model.cfg, 2, 48).items()}
        _, grads[dispatch] = loss_and_grads(model.loss, params, batch)
    for path, g in _paths(grads["einsum"]):
        h = _get(grads["scatter"], path)
        np.testing.assert_allclose(_np(h), _np(g), rtol=0,
                                   atol=GRAD_SCALE_TOL * float(g.abs().max()) + 1e-12)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def _tree(rng) -> dict:
    return {"w_col": rng.standard_normal((6, 10)).astype(np.float32),
            "stack": {"w3": rng.standard_normal((2, 5, 4)).astype(np.float32),
                      "b": rng.standard_normal((7,)).astype(np.float32)}}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("param_dtype,moment_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16")])
def test_optimizer_updates_match_reference(opt, moment_dtype, param_dtype):
    rng = np.random.default_rng(5)
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), _tree(rng))
    params = jax.tree_util.tree_map(lambda a: _t(a), jparams)
    jinit, jupd = ((jadamw_init, jadamw_update) if opt == "adamw"
                   else (jadafactor_init, jadafactor_update))
    init, upd = (adamw_init, adamw_update) if opt == "adamw" else (adafactor_init,
                                                                   adafactor_update)
    jstate, state = jinit(jparams, moment_dtype), init(params, moment_dtype)
    jupd = jax.jit(functools.partial(jupd, lr=1e-2))
    for _ in range(3):
        g = _tree(rng)
        g["stack"]["b"][2] = 0.0
        jg = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g)
        jparams, jstate = jupd(jg, jstate, jparams)
        params, state = upd(jax.tree_util.tree_map(_t, jg), state, params, lr=1e-2)
    assert int(state["step"]) == int(jstate["step"]) == 3
    assert state["step"].dtype == torch.int32
    rtol = 2 ** -8 if "bfloat16" in (param_dtype, moment_dtype) else F32_RTOL
    for want, got in ((jparams, params), ({k: v for k, v in jstate.items() if k != "step"},
                                          {k: v for k, v in state.items() if k != "step"})):
        for path, w in _paths(jax.tree_util.tree_map(np.asarray, want)):
            t = _get(got, path)
            assert str(t.dtype).removeprefix("torch.") == str(w.dtype), path
            np.testing.assert_allclose(_np(t), np.asarray(w, np.float32), rtol=rtol,
                                       atol=1e-7, err_msg=path)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_reference(accum):
    """Three steps of reduced qwen2-0.5b (AdamW, f32 moments) at
    ``accum_steps`` 1 and 2: the losses within rtol 1e-5, the grad norms
    too, and each parameter leaf's distance from the reference's within
    1e-2 of how far the reference moved it. Not elementwise: AdamW divides
    each gradient by its own root mean square, so an element whose
    gradient is float32 noise in both packages moves by up to lr in either
    direction (one element of 16,384 of ``wu_col`` differs by 4.4e-5). The
    key bias's gradient is a small difference of large terms (a bias on
    every key moves the scores only through RoPE), so the order of float32
    sums alone puts ``bk_col`` at 0.8-0.9e-3 of its movement."""
    jmodel, jparams, model, params = pair_of_models("qwen2-0.5b")
    start = jax.tree_util.tree_map(np.asarray, jparams)
    jstep = jax.jit(jmake_train_step(jmodel, lr=1e-3, accum_steps=accum))
    step = make_train_step(model, lr=1e-3, accum_steps=accum)
    jopt, opt = jinit_opt_state(jmodel, jparams), init_opt_state(model, params)
    for i in range(3):
        batch = _lm_batch(model.cfg, 4, 40, seed=i)
        jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, m = step(params, opt, {k: torch.tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
    for path, w in _paths(jax.tree_util.tree_map(np.asarray, jparams)):
        moved = np.linalg.norm(w - _get(start, path))
        assert moved > 0, path
        assert np.linalg.norm(_np(_get(params, path)) - w) <= 1e-2 * moved, path
    assert set(m["grad_norms"]) == {p for p, _ in _paths(params)}


def test_a_batch_that_does_not_split_is_refused():
    """``accum_steps`` 4 on a batch of 6: the reference's reshape into
    microbatches fails, and the port's step raises rather than train on 4
    of the 6 sequences."""
    jmodel, jparams, model, params = pair_of_models("qwen2-0.5b")
    batch = _lm_batch(model.cfg, 6, 16)
    with pytest.raises(TypeError):
        jmake_train_step(jmodel, lr=1e-3, accum_steps=4)(
            jparams, jinit_opt_state(jmodel, jparams),
            {k: jnp.asarray(v) for k, v in batch.items()})
    before = {p: t.clone() for p, t in _paths(params)}
    with pytest.raises(ValueError, match="does not split into 4"):
        make_train_step(model, lr=1e-3, accum_steps=4)(
            params, init_opt_state(model, params), {k: torch.tensor(v) for k, v in batch.items()})
    assert all(torch.equal(t, before[p]) for p, t in _paths(params))


def _bf16_errors(loss_fn, loss_fn32, params, params32, batch, grad) -> dict[str, float]:
    """Each leaf's ||g_bf16 - g_f32|| / ||g_f32|| for one package."""
    g16, g32 = grad(loss_fn, params, batch), grad(loss_fn32, params32, batch)
    return {p: float(np.linalg.norm(_np(_get(g16, p)) - _np(w)) / np.linalg.norm(_np(w)))
            for p, w in _paths(g32)}


def test_bf16_gradient_error_is_the_reference_s(capsys):
    """The bf16 step's gradients against the float32 step's on the same
    bf16 weights (cast up), in each package: reduced qwen2-0.5b, two
    sequences of 128 loader tokens. Each leaf's relative norm error in the
    port within twice the reference's own plus 1e-3 (bf16 rounding lands
    elsewhere in each package). Both are printed: the reference's key bias
    errs most of its attention leaves too (a small difference of large
    terms through RoPE), the rule behind the card's wider limit on it."""
    import dataclasses

    from repro.models import build_model as jbuild_model
    from repro_torch.models import build_model

    jmodel, jparams, model, params = pair_of_models("qwen2-0.5b", dtype="bfloat16")
    np_batch = JTokenLoader(global_batch=2, seq_len=128, vocab=model.cfg.vocab_size,
                            seed=0).batch(100)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    tb = {k: torch.tensor(v) for k, v in np_batch.items()}
    jmodel32 = jbuild_model(dataclasses.replace(jmodel.cfg, dtype="float32"))
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    want = _bf16_errors(jmodel.loss, jmodel32.loss, jparams,
                        jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams), jb,
                        lambda f, p, b: jax.jit(jax.grad(f))(p, b))
    params32 = jax.tree_util.tree_map(lambda t: t.float(), params)
    got = _bf16_errors(model.loss, model32.loss, params, params32, tb,
                       lambda f, p, b: loss_and_grads(f, p, b)[1])
    with capsys.disabled():
        print("\nbf16 vs float32 gradient, rel norm err by leaf (reference, port): "
              + ", ".join(f"{p} {want[p]:.4f} {got[p]:.4f}" for p in sorted(want)))
    for p in want:
        assert got[p] <= 2 * want[p] + 1e-3, (p, got[p], want[p])


def test_init_opt_state_without_memory():
    _, _, model, params = pair_of_models("qwen2-0.5b")
    st = init_opt_state(model, params, materialize=False)
    assert st["m"]["embed"].device.type == "meta"
    assert st["m"]["embed"].shape == params["embed"].shape


# ---------------------------------------------------------------------------
# Loader and compression
# ---------------------------------------------------------------------------


def test_loader_batches_are_byte_identical_including_after_a_dead_host():
    jmon, mon = JStragglerMonitor(n_hosts=4), StragglerMonitor(n_hosts=4)
    jl = JTokenLoader(global_batch=12, seq_len=33, vocab=151936, seed=3, n_shards=8,
                      monitor=jmon)
    tl = TokenLoader(global_batch=12, seq_len=33, vocab=151936, seed=3, n_shards=8,
                     monitor=mon)
    assert tl.n_shards == jl.n_shards == 4  # clamped to a divisor of the batch
    for step in (0, 5):
        a, b = jl.batch(step), tl.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    jmon.mark_dead(1)
    mon.mark_dead(1)
    assert mon.plan_shards(4) == jmon.plan_shards(4)
    shards = sorted(s for ss in mon.plan_shards(4).values() for s in ss)
    assert tl.batch(7, shards)["tokens"].tobytes() == jl.batch(7, shards)["tokens"].tobytes()


def test_compression_payloads_and_residuals_are_bitwise_the_reference():
    rng = np.random.default_rng(6)
    g = {"w": rng.standard_normal((5, 9)).astype(np.float32),
         "b": np.array([0.5, -1.5, 2.5, 127.0, -127.0], np.float32)}  # .5 ties at scale 1
    g["w"][2] = 0.0  # an all-zero row: scale 1
    jst, st = jef_init(g), ef_init({k: torch.tensor(v) for k, v in g.items()})
    for i in range(3):
        gi = {k: (v * (i + 1)).astype(np.float32) for k, v in g.items()}
        jdeq, jst = jcompressed_update(gi, jst)
        deq, st = compressed_gradient_update({k: torch.tensor(v) for k, v in gi.items()}, st)
        for k in g:
            assert _np(deq[k]).tobytes() == np.asarray(jdeq[k]).tobytes(), k
            assert _np(st.residual[k]).tobytes() == np.asarray(jst.residual[k]).tobytes(), k
    # the all-reduce over an axis needs the mesh that names it
    # (tests/test_torch_distributed.py runs it over four ranks)
    with pytest.raises(ValueError, match="needs the mesh that names the axis"):
        compressed_gradient_update(deq, st, axis_name="pod")


# ---------------------------------------------------------------------------
# Checkpoints, both ways
# ---------------------------------------------------------------------------


def _ckpt_tree(rng) -> dict:
    return {"params": {"w_col": rng.standard_normal((8, 16)).astype(np.float32),
                       "embed": rng.standard_normal((32, 8)).astype(np.float32)},
            "opt": {"m": {"w_col": rng.standard_normal((8, 16)).astype(np.float32)},
                    "step": np.int32(7)}}


def _bits_equal(a, b) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.tobytes() == b.tobytes()


def test_reference_checkpoint_loads_in_the_port_bitwise(tmp_path):
    tree = _ckpt_tree(np.random.default_rng(7))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jtree["params"]["embed"] = jtree["params"]["embed"].astype(jnp.bfloat16)
    jtree["opt"]["step"] = jnp.asarray(7, jnp.int32)
    jsave_checkpoint(str(tmp_path), 4, jtree)
    step, loaded, _ = load_checkpoint(str(tmp_path))
    got = restore_onto_device(loaded, "cpu")
    assert step == 4
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32 and int(got["opt"]["step"]) == 7
    for path, want in _paths(jax.tree_util.tree_map(np.asarray, jtree)):
        t = _get(got, path)
        if t.dtype == torch.bfloat16:
            _bits_equal(t.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
        else:
            _bits_equal(t.numpy(), want)


def test_port_checkpoint_loads_in_the_reference_bitwise(tmp_path):
    tree = jax.tree_util.tree_map(torch.tensor, _ckpt_tree(np.random.default_rng(8)))
    tree["params"]["embed"] = tree["params"]["embed"].to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 9, tree)
    step, loaded, meta = jload_checkpoint(str(tmp_path))
    got = restore_onto_mesh(loaded, jax.tree_util.tree_map(lambda x: None, loaded))
    assert step == 9 and meta["leaves"]["opt.step"]["dtype"] == "int32"
    assert got["params"]["embed"].dtype == jnp.bfloat16
    assert got["opt"]["step"].dtype == jnp.int32
    for path, t in _paths(tree):
        want = np.asarray(_get(got, path))
        if t.dtype == torch.bfloat16:
            _bits_equal(want.view(np.int16), t.view(torch.int16).numpy())
        else:
            _bits_equal(want, t.numpy())
    # the re-view rule: a uint16 leaf stays uint16 where dtypes names another type
    kept = restore_onto_device(loaded, "cpu", dtypes={"params.embed": "uint16"})
    assert kept["params"]["embed"].dtype == torch.uint16


def test_manager_snapshots_before_save_returns(tmp_path):
    """``save`` copies every leaf to host memory before it returns: a tensor
    updated in place afterwards (the optimizer's next step) leaves the
    file as it was at the call. Retention keeps the newest ``keep``."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for s in range(3):
        mgr.save(s, {"params": {"w": w}})
        w.add_(100.0)  # while the write may still run
    mgr.flush()
    assert mgr.latest_step() == 2 and mgr.last["bytes"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001", "step_00000002"]
    _, tree, _ = load_checkpoint(str(tmp_path), step=1)
    np.testing.assert_array_equal(tree["params"]["w"],
                                  np.arange(12, dtype=np.float32).reshape(3, 4) + 100.0)
