"""The recurrent families' training path (``_xlstm_loss``, ``_zamba_loss``
and the checkpointed ``models/ssm.py``) against the JAX package's.

Every case feeds the same numpy-seeded inputs through the reference, under
``jax.vjp`` or ``jax.value_and_grad``, and through the port, in float32.
Stated tolerances: values within 1e-5 (the SSD's, as
``tests/test_torch_ssm.py`` holds them) or rtol 1e-5 (the loss); each
gradient leaf within 1e-4 of that leaf's largest |g| in the reference
(``tests/test_torch_train.py``'s rule). Each planted fault of
``chip_smoke.planted_fault`` (the SSD carry or the sLSTM's ``y_prev``
detached, zamba2's shared attention detached in one group) fails that same
comparison. The bf16-against-float32 gradient errors of both packages are
printed by leaf: the limits of ``chip_smoke.py``'s recurrent training check
rest on them.
"""
from __future__ import annotations

import dataclasses
import functools
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro.configs import reduced_config as jreduced_config
from repro.data.loader import TokenLoader as JTokenLoader
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.train.step import init_opt_state as jinit_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import reduced_config
from repro_torch.models import build_model, layers, ssm, zoo
from repro_torch.train.step import init_opt_state, loss_and_grads, make_train_step
from torch_zoo_pair import pair_of_models

VALUE_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_SCALE_TOL = 1e-4  # of the leaf's largest |g| in the reference
RECURRENT = ["xlstm-350m", "zamba2-7b"]
SEQ = 96  # three chunks of 32, past reduced zamba2's window of 64


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes: two threads, not every core of a shared machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _worst(got: dict, want: dict) -> float:
    """The largest ratio, over the leaves of ``want`` (numpy), of a leaf's
    max |got - want| to GRAD_SCALE_TOL times its largest |want|: at most 1
    when every leaf agrees."""
    ratios = []
    for k, w in want.items():
        g = _np(got[k])
        assert g.shape == w.shape, k
        ratios.append(float(np.abs(g - w).max()) / (GRAD_SCALE_TOL * float(np.abs(w).max())))
    return max(ratios)


def _reference_vjp(jfn, args: dict, cotangents: list[np.ndarray]):
    """The reference's outputs and its gradients in each of ``args`` (by
    name), through ``jax.vjp`` under one ``jax.jit``."""
    names = list(args)

    def outs_and_grads(a, c):
        outs, pull = jax.vjp(lambda *x: jfn(**dict(zip(names, x))), *a)
        return outs, pull(c)

    outs, grads = jax.jit(outs_and_grads)(tuple(jnp.asarray(args[n]) for n in names),
                                          tuple(jnp.asarray(c) for c in cotangents))
    return [np.asarray(o) for o in outs], dict(zip(names, (np.asarray(g) for g in grads)))


def _port_vjp(tfn, args: dict, cotangents: list[np.ndarray]):
    """The port's outputs and its gradients in each of ``args``: the
    backward of sum(out * cotangent)."""
    targs = {n: torch.tensor(a, requires_grad=True) for n, a in args.items()}
    outs = tfn(**targs)
    sum((o.float() * torch.tensor(c)).sum() for o, c in zip(outs, cotangents)).backward()
    return outs, {n: t.grad for n, t in targs.items()}


# ---------------------------------------------------------------------------
# The chunked SSD and the three layers
# ---------------------------------------------------------------------------


def _ssd_args(rng, S: int, with_h0: bool) -> dict:
    B, H, P, N = 2, 3, 4, 5
    f = np.float32
    args = {"x": (rng.normal(size=(B, S, H, P)) * 0.5).astype(f),
            "a_log": -rng.uniform(0.0, 0.3, size=(B, S, H)).astype(f),
            "b": (rng.normal(size=(B, S, N)) * 0.5).astype(f),
            "c": (rng.normal(size=(B, S, N)) * 0.5).astype(f),
            "dt": rng.uniform(0.1, 1.0, size=(B, S, H)).astype(f)}
    if with_h0:
        args["h0"] = (rng.normal(size=(B, H, N, P)) * 0.5).astype(f)
    return args


@functools.cache
def _ssd_case(S: int, with_h0: bool):
    """The inputs and cotangents, and the reference's y, final state and
    gradients."""
    rng = np.random.default_rng(S + 7 * with_h0)
    args = _ssd_args(rng, S, with_h0)
    B, _, H, P = args["x"].shape
    cot = [rng.normal(size=(B, S, H, P)).astype(np.float32),
           rng.normal(size=(B, H, args["b"].shape[-1], P)).astype(np.float32)]
    return (args, cot, *_reference_vjp(lambda **a: jssm.ssd_chunked(chunk=32, **a), args, cot))


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "carry-detached"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
@pytest.mark.parametrize("S", [45, 96], ids=["ragged", "three-chunks"])
def test_ssd_chunked_value_and_gradients(S, with_h0, fault):
    """y, the final state and the gradients in x, a_log, b, c, dt (and h0)
    at chunk 32: S = 45 pads its second chunk. Log decays of at most 0.3 a
    step, so a chunk's state reaches the next. With the carry detached
    between chunks, the gradients leave the tolerance."""
    args, cot, (jy, jh), jgrads = _ssd_case(S, with_h0)
    with cs.planted_fault("ssd carry") if fault else nullcontext():
        (y, h), grads = _port_vjp(lambda **a: ssm.ssd_chunked(chunk=32, **a), args, cot)
    np.testing.assert_allclose(_np(y), jy, rtol=0, atol=VALUE_ATOL)
    np.testing.assert_allclose(_np(h), jh, rtol=0, atol=VALUE_ATOL)
    worst = _worst(grads, jgrads)
    assert (worst > 1) if fault else (worst <= 1), worst


LAYERS = {  # kind: (config, param shapes, layer, its planted fault)
    "mamba2": ("zamba2-7b", "mamba2_param_shapes", "mamba2_layer", "ssd carry"),
    "mlstm": ("xlstm-350m", "mlstm_param_shapes", "mlstm_layer", "ssd carry"),
    "slstm": ("xlstm-350m", "slstm_param_shapes", "slstm_layer", "slstm y_prev"),
}


def _layer_params(shapes: dict, rng) -> dict:
    """Weights at scale 1/sqrt(fan_in); ``d_skip`` near 1; ``dt_bias`` and
    ``a_log`` drawn near 0 (``init`` makes them 0)."""
    out = {}
    for name, shape in shapes.items():
        if name in ("dt_bias", "a_log"):
            a = rng.normal(size=shape) * 0.5
        elif name == "d_skip":
            a = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            a = rng.normal(size=shape) / np.sqrt(fan_in)
        out[name] = a.astype(np.float32)
    return out


def _split(a: dict):
    """(the layer's parameters, its input x)."""
    return {k: v for k, v in a.items() if k != "x"}, a["x"]


@functools.cache
def _layer_case(kind: str):
    """The inputs and cotangent, and the reference's output and gradients."""
    arch, shapes, layer, _ = LAYERS[kind]
    cfg = reduced_config(arch)
    rng = np.random.default_rng(31)
    params = _layer_params(getattr(ssm, shapes)(cfg), rng)
    args = {"x": rng.normal(size=(2, SEQ, cfg.d_model)).astype(np.float32), **params}
    cot = [rng.normal(size=(2, SEQ, cfg.d_model)).astype(np.float32)]
    jcfg = jreduced_config(arch)
    return (args, cot, *_reference_vjp(lambda **a: (getattr(jssm, layer)(*_split(a), jcfg),),
                                       args, cot))


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "planted-fault"])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_value_and_every_gradient(kind, fault):
    """The layer's output and the gradient in its input and every
    parameter, at the reduced config's widths and S = 96 (three chunks of
    32). With the SSD carry (Mamba2, mLSTM) or ``y_prev`` (sLSTM) detached,
    the gradients leave the tolerance."""
    arch, _, layer, planted = LAYERS[kind]
    cfg = reduced_config(arch)
    args, cot, (want,), jgrads = _layer_case(kind)
    with cs.planted_fault(planted) if fault else nullcontext():
        (got,), grads = _port_vjp(lambda **a: (getattr(ssm, layer)(*_split(a), cfg),),
                                  args, cot)
    # the chunked SSD's three-operand contractions: tests/test_torch_ssm.py's 1e-4
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=VALUE_ATOL if kind == "slstm" else 1e-4)
    worst = _worst(grads, jgrads)
    assert (worst > 1) if fault else (worst <= 1), worst


# ---------------------------------------------------------------------------
# Model.loss and every gradient leaf
# ---------------------------------------------------------------------------


def _paths(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p, v


def _batch(cfg, B: int = 2, S: int = SEQ, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, :3] = -1  # ignored
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": labels}


@functools.cache
def _reference(name: str):
    """The reduced pair of models (remat on), and the reference's loss and
    gradient leaves on one batch, shared by every case of ``name``: the
    reference's remat changes how it differentiates, not what."""
    pair = pair_of_models(name, remat=True)
    jmodel, jparams, model, _ = pair
    batch = _batch(model.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return pair, batch, float(jloss), dict(_paths(jax.tree_util.tree_map(np.asarray, jgrads)))


def _loss_both(name: str, remat: bool, fault=None):
    """(reference loss, its gradient leaves, port loss, its gradient
    leaves) of reduced ``name`` on one batch, the port's with ``remat`` on
    or off; ``fault`` a ``planted_fault`` argument tuple for the port's
    step."""
    (_, _, model, params), batch, jloss, jgrads = _reference(name)
    model = build_model(dataclasses.replace(model.cfg, remat=remat))
    with cs.planted_fault(*fault) if fault else nullcontext():
        loss, grads = loss_and_grads(model.loss, params,
                                     {k: torch.tensor(v) for k, v in batch.items()})
    assert not any(p.requires_grad for _, p in _paths(params))
    return jloss, jgrads, loss, dict(_paths(grads))


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("name", RECURRENT)
def test_model_loss_and_gradients_match_reference(name, remat):
    jloss, jgrads, loss, grads = _loss_both(name, remat)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(jgrads)
    assert _worst(grads, jgrads) <= 1


# (model, planted_fault's arguments): the SSD carry or y_prev detached in
# every layer, the shared attention in one of zamba2's two groups
MODEL_FAULTS = {
    "xlstm-ssd-carry": ("xlstm-350m", ("ssd carry",)),
    "xlstm-y-prev": ("xlstm-350m", ("slstm y_prev",)),
    "zamba2-ssd-carry": ("zamba2-7b", ("ssd carry",)),
    "zamba2-shared-attention-group-1": ("zamba2-7b", ("shared attention", 1, 2)),
}


@pytest.mark.parametrize("case", sorted(MODEL_FAULTS))
def test_planted_fault_fails_the_comparison(case):
    """The fault leaves the loss as it is and moves the gradients out of
    the tolerance, with remat on (a checkpointed layer runs its fault again
    when it is recomputed)."""
    name, fault = MODEL_FAULTS[case]
    jloss, jgrads, loss, grads = _loss_both(name, True, fault)
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert _worst(grads, jgrads) > 1


@pytest.mark.parametrize("name", RECURRENT)
def test_loss_path_forward_is_the_prefill_s_bit_for_bit(name):
    """The loss's layer stack (``train``, remat on) under ``no_grad`` and
    with autograd recording through its checkpoints gives the prefill's
    hidden states bit for bit. zamba2's prefill attends on the kernel and
    its loss on ``attention_train``: here both attend on
    ``attention_train``, the one thing the two stacks may do differently."""
    _, _, model, params = pair_of_models(name, remat=True)
    cfg = model.cfg
    tokens = torch.tensor(_batch(cfg)["tokens"])
    h0 = zoo.embed_lookup(params["embed"], tokens).to(torch.float32)
    B, S = tokens.shape
    positions = torch.arange(S)[None, :].expand(B, S)
    if name == "zamba2-7b":
        def stack(train):
            return zoo._zamba_forward(params, h0, cfg, positions, train=train)
    else:
        def stack(train):
            return zoo._xlstm_forward(params, h0, cfg, train=train)
    real = layers.attention_chunked
    layers.attention_chunked = layers.attention_train
    try:
        with torch.no_grad():
            want = stack(False)
            quiet = stack(True)
        leaves = [p for _, p in _paths(params)]
        for p in leaves:
            p.requires_grad_(True)
        try:
            recorded = stack(True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    finally:
        layers.attention_chunked = real
    assert recorded.grad_fn is not None
    assert torch.equal(quiet, want) and torch.equal(recorded.detach(), want)


# ---------------------------------------------------------------------------
# Train steps and the bf16 gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RECURRENT)
def test_three_adamw_steps_match_reference(name):
    """Three steps of the reduced model (AdamW, float32 moments, remat on):
    the losses and grad norms within rtol 1e-5, and each parameter leaf's
    distance from the reference's within 1e-2 of how far the reference
    moved it (``tests/test_torch_train.py``'s rule: AdamW moves an element
    whose gradient is float32 noise by up to lr in either direction)."""
    jmodel, jparams, model, params = pair_of_models(name, remat=True)
    start = jax.tree_util.tree_map(np.asarray, jparams)
    jstep = jax.jit(jmake_train_step(jmodel, lr=1e-3))
    step = make_train_step(model, lr=1e-3)
    jopt, opt = jinit_opt_state(jmodel, jparams), init_opt_state(model, params)
    for i in range(3):
        batch = _batch(model.cfg, 4, 40, seed=i)
        jparams, jopt, jm = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, m = step(params, opt, {k: torch.tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
    got = dict(_paths(params))
    for path, w in _paths(jax.tree_util.tree_map(np.asarray, jparams)):
        moved = np.linalg.norm(w - dict(_paths(start))[path])
        assert moved > 0, path
        assert np.linalg.norm(_np(got[path]) - w) <= 1e-2 * moved, path


def _bf16_errors(g16: dict, g32: dict) -> dict[str, float]:
    """||g_bf16 - g_f32|| / ||g_f32|| by leaf: the unit of the card's check."""
    return cs.rel_errors({k: torch.tensor(_np(v)) for k, v in g16.items()},
                         {k: torch.tensor(_np(v)) for k, v in g32.items()})


BF16_CASES = {  # name: (config, its changes)
    # xlstm at its published width, one group of 8 layers (7 mLSTM, 1 sLSTM)
    # with a vocab of 1,024: its bf16 gradient errs by tens of percent in
    # both packages, as the card sees at 24 layers; at width 64 by 1%
    "xlstm-350m-width-1024-8-layers": ("xlstm-350m", {
        "d_model": 1024, "n_layers": 8, "slstm_every": 8, "vocab_size": 1024,
        "ssm_chunk": 64}),
    "zamba2-7b": ("zamba2-7b", {}),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_gradient_error_is_the_reference_s(case, capsys):
    """The bf16 step's gradients against the float32 step's on the same
    bf16 weights (cast up), in each package, by leaf: two sequences of
    128 loader tokens. Each of the port's errors within twice
    the reference's own plus 1e-3 (bf16 rounding lands elsewhere in each
    package). Both are printed: the limits of ``chip_smoke.py``'s bf16
    check rest on them."""
    name, replace = BF16_CASES[case]
    jmodel, jparams, model, params = pair_of_models(name, dtype="bfloat16", **replace)
    np_batch = JTokenLoader(global_batch=2, seq_len=128, vocab=model.cfg.vocab_size,
                            seed=0).batch(100)
    jmodel32 = jbuild_model(dataclasses.replace(jmodel.cfg, dtype="float32"))
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    jgrad = jax.jit(jax.grad(jmodel.loss))
    jgrad32 = jax.jit(jax.grad(jmodel32.loss))
    want = _bf16_errors(
        dict(_paths(jgrad(jparams, jb))),
        dict(_paths(jgrad32(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams),
                            jb))))
    tb = {k: torch.tensor(v) for k, v in np_batch.items()}
    params32 = jax.tree_util.tree_map(lambda t: t.float(), params)
    got = _bf16_errors(dict(_paths(loss_and_grads(model.loss, params, tb)[1])),
                       dict(_paths(loss_and_grads(model32.loss, params32, tb)[1])))
    with capsys.disabled():
        print(f"\n{case}: bf16 vs float32 gradient, rel norm err by leaf "
              "(reference, port): "
              + ", ".join(f"{p} {want[p]:.4f} {got[p]:.4f}" for p in sorted(want)))
    for p in want:
        assert got[p] <= 2 * want[p] + 1e-3, (p, got[p], want[p])


def test_gradient_recurrence_check_holds_and_sees_each_fault(monkeypatch):
    """``chip_smoke.grad_recurrence_check`` on the reduced models (S = 96,
    three chunks of 32): each recurrent layer's gradients through the
    training path within REC_GRAD_RECURRENCE_TOL of its decode step
    unrolled (seen: ~1e-6), and each planted fault past it (seen: 3-9%;
    the check raises otherwise)."""
    monkeypatch.setattr(cs, "REC_GRAD_CHECK_SEQ", SEQ)
    for name in RECURRENT:
        model = build_model(reduced_config(name))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        out = cs.grad_recurrence_check(model.cfg, params, torch.device("cpu"))
        assert set(out) == {layer for _, layer, _, _ in cs.REC_GRAD_LAYERS[name]}
        for got in out.values():
            assert got["max_rel_err"] <= cs.REC_GRAD_RECURRENCE_TOL < got["planted_max_rel_err"]
