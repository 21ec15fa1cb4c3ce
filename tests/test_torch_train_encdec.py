"""The enc-dec family's training path (``_whisper_loss`` with
``encdec_decoder_forward`` and ``encoder_forward(train=True)``) against the
JAX package's.

Reduced whisper-small (2 encoder and 2 decoder layers, d_model 64, QKV
biases) on the reference's weights (``tests/torch_zoo_pair.py``), in
float32, at 32 frames and at the published 1,500 (ragged against both the
512-row query block and the 1,024-row key block), with S = 40 and 600 (past
the loss's 512-row chunk). Stated tolerances: the stacks' values within
1e-5; the loss within rtol 1e-5; each gradient leaf within 1e-4 of that
leaf's largest |g| in the reference (``tests/test_torch_train.py``'s rule).
One leaf has no gradient in exact arithmetic: the cross attention's key
bias (a bias added to every key shifts a query's scores alike, and the
cross keys take no RoPE); both packages give rounding there, so it is held
to zero, within 1e-4 of the largest |g| of the value bias beside it. Each
planted fault of ``chip_smoke.encdec_fault`` fails the same comparison.
The bf16-against-float32 gradient errors of both packages are printed by
leaf: the limits of ``chip_smoke.py``'s enc-dec training check rest on
them.
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
from repro.data.loader import TokenLoader as JTokenLoader
from repro.launch.train import train_loop as jtrain_loop
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtransformer
from repro.train.step import init_opt_state as jinit_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.launch.train import sequence_bytes, train_loop
from repro_torch.models import build_model, layers, transformer
from repro_torch.train.step import init_opt_state, loss_and_grads, make_train_step
from torch_zoo_pair import close, pair_of_models

ENCDEC = "whisper-small"
VALUE_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_SCALE_TOL = 1e-4  # of the leaf's largest |g| in the reference
ZERO_GRAD = {"layers/xattn/bk_col": "layers/xattn/bv_col"}  # leaf: the leaf whose scale holds it
CASES = [(32, 40), (32, 600), (1500, 40), (1500, 600)]  # (frames, S)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes: two threads, not every core of a shared machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _paths(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, p)
        else:
            yield p, v


def _worst(got: dict, want: dict) -> float:
    """The largest ratio, over the leaves of ``want`` (numpy), of a leaf's
    max |got - want| to GRAD_SCALE_TOL times its largest |want| (for a
    ZERO_GRAD leaf, the largest |want| of the leaf named beside it): at
    most 1 when every leaf agrees."""
    ratios = []
    for k, w in want.items():
        g = _np(got[k])
        assert g.shape == w.shape, k
        scale = float(np.abs(want[ZERO_GRAD.get(k, k)]).max())
        ratios.append(float(np.abs(g - w).max()) / (GRAD_SCALE_TOL * scale))
    return max(ratios)


def _batch(cfg, B: int, S: int, frames: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, :3] = -1  # ignored
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": labels,
            "frames": (rng.normal(size=(B, frames, cfg.d_model)) * 0.5).astype(np.float32)}


def _torch(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.cache
def _reference(frames: int, S: int):
    """The reduced pair of models at ``frames`` (remat on), one batch of two
    clips, and the reference's loss and gradient leaves on it, shared by
    the cases of (frames, S): the reference's remat changes how it
    differentiates, not what."""
    pair = pair_of_models(ENCDEC, remat=True, frontend_tokens=frames)
    jmodel, jparams, model, _ = pair
    batch = _batch(model.cfg, 2, S, frames)
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, _jax(batch))
    return pair, batch, float(jloss), dict(_paths(jax.tree_util.tree_map(np.asarray, jgrads)))


def _loss_both(frames: int, S: int, remat: bool, fault=None):
    """(reference loss, its gradient leaves, port loss, its gradient
    leaves), the port's with ``remat`` on or off; ``fault`` an
    ``encdec_fault`` argument tuple for the port's step."""
    (_, _, model, params), batch, jloss, jgrads = _reference(frames, S)
    model = build_model(dataclasses.replace(model.cfg, remat=remat))
    with cs.encdec_fault(*fault) if fault else nullcontext():
        loss, grads = loss_and_grads(model.loss, params, _torch(batch))
    assert not any(p.requires_grad for _, p in _paths(params))
    return jloss, jgrads, loss, dict(_paths(grads))


# ---------------------------------------------------------------------------
# The stacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frames,S", CASES)
def test_encoder_and_decoder_training_stacks_match_reference(frames, S):
    """``encoder_forward(train=True)`` on the frames' rows and
    ``encdec_decoder_forward`` on S token rows over those encoder rows, on
    the same inputs and positions as the reference's, remat on."""
    (jmodel, jparams, model, params), _, _, _ = _reference(frames, S)
    cfg = model.cfg
    rng = np.random.default_rng(frames + S)
    x = rng.normal(size=(2, frames, cfg.d_model)).astype(np.float32)
    h = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    enc_pos = np.arange(frames)[None].repeat(2, 0)
    pos = np.arange(S)[None].repeat(2, 0)
    got = transformer.encoder_forward(params["encoder_layers"], torch.tensor(x), cfg,
                                      torch.tensor(enc_pos), train=True)
    jcfg = jmodel.cfg
    want = jax.jit(lambda lp, xx, p: jtransformer.encoder_forward(lp, xx, jcfg, p))(
        jparams["encoder_layers"], jnp.asarray(x), jnp.asarray(enc_pos))
    close(got, want, VALUE_ATOL)
    got = transformer.encdec_decoder_forward(
        params["layers"], torch.tensor(h), torch.tensor(x), cfg,
        positions=torch.tensor(pos), enc_positions=torch.tensor(enc_pos))
    want = jax.jit(lambda lp, hh, enc, p, ep: jtransformer.encdec_decoder_forward(
        lp, hh, enc, jcfg, positions=p, enc_positions=ep))(
        jparams["layers"], jnp.asarray(h), jnp.asarray(x), jnp.asarray(pos), jnp.asarray(enc_pos))
    close(got, want, VALUE_ATOL)


def test_training_encoder_is_the_prefill_s_bit_for_bit():
    """The encoder's training stack (remat on) under ``no_grad`` and with
    autograd recording through its checkpoints gives the prefill's stack
    bit for bit, both attending on ``attention_train``: the one thing the
    two stacks do differently."""
    (_, _, model, params), _, _, _ = _reference(1500, 40)
    cfg = model.cfg
    x = torch.tensor(np.random.default_rng(5).normal(size=(1, 1500, cfg.d_model)),
                     dtype=torch.float32)
    pos = torch.arange(1500)[None]
    real = layers.attention_chunked
    layers.attention_chunked = layers.attention_train
    try:
        with torch.no_grad():
            want = transformer.encoder_forward(params["encoder_layers"], x, cfg, pos)
            quiet = transformer.encoder_forward(params["encoder_layers"], x, cfg, pos,
                                                train=True)
        leaves = [p for _, p in _paths(params["encoder_layers"])]
        for p in leaves:
            p.requires_grad_(True)
        try:
            recorded = transformer.encoder_forward(params["encoder_layers"], x, cfg, pos,
                                                   train=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    finally:
        layers.attention_chunked = real
    assert recorded.grad_fn is not None
    assert torch.equal(quiet, want) and torch.equal(recorded.detach(), want)


# ---------------------------------------------------------------------------
# Model.loss and every gradient leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("frames,S", CASES)
def test_model_loss_and_gradients_match_reference(frames, S, remat):
    jloss, jgrads, loss, grads = _loss_both(frames, S, remat)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    assert sorted(grads) == sorted(jgrads)
    assert _worst(grads, jgrads) <= 1
    for k, beside in ZERO_GRAD.items():  # rounding in both: far under its neighbour's scale
        assert np.abs(jgrads[k]).max() <= 1e-4 * np.abs(jgrads[beside]).max(), k


# (frames, S, encdec_fault's arguments, whether it fails the comparison)
FAULTS = {
    "encoder-detached": (32, 40, ("encoder detached",), True),
    "cross-query-bias-dropped": (32, 40, ("cross query bias",), True),
    "cross-keys-unmasked-1500-frames": (1500, 40, ("cross keys unmasked",), True),
    # 32 rows fill their one key block: nothing is padded, nothing to unmask
    "cross-keys-unmasked-32-frames-invisible": (32, 40, ("cross keys unmasked",), False),
    "cross-attention-cut-layer-0": (32, 40, ("cross attention", 0), True),
    "cross-attention-cut-layer-1": (32, 40, ("cross attention", 1), True),
}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_planted_fault_fails_the_comparison(case):
    """Each fault moves the loss (the bias dropped, the padding attended) or
    the gradients (a cut) out of the tolerance, with remat on (a
    checkpointed layer runs its fault again when it is recomputed). The
    unmasked keys show only where the encoder's rows leave their last key
    block ragged: at 1,500 frames, not at 32."""
    frames, S, fault, fails = FAULTS[case]
    jloss, jgrads, loss, grads = _loss_both(frames, S, True, fault)
    held = (abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
            and _worst(grads, jgrads) <= 1)
    assert held is not fails, (float(loss), jloss, _worst(grads, jgrads))


def test_loss_cross_query_carries_its_bias_and_the_prefill_s_does_not():
    """The reference's quirk, in both packages: another ``xattn.bq_col``
    (unit normal, so that its shift of the scores shows in float32) moves
    the loss (the training forward adds the bias to the cross query) and
    leaves the prefill's logits and caches bit for bit (its cross query
    has none)."""
    (jmodel, jparams, model, params), batch, _, _ = _reference(32, 40)
    bias = np.random.default_rng(9).normal(
        size=params["layers"]["xattn"]["bq_col"].shape).astype(np.float32)
    other = {**params, "layers": {**params["layers"], "xattn": {
        **params["layers"]["xattn"], "bq_col": torch.tensor(bias)}}}
    jother = jax.tree_util.tree_map(lambda a: a, jparams)
    jother["layers"]["xattn"]["bq_col"] = jnp.asarray(bias)
    prompt = {k: v[:, :8] if k == "tokens" else v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        assert float(model.loss(params, _torch(batch))) != float(model.loss(other, _torch(batch)))
        a, b = model.prefill(params, _torch(prompt)), model.prefill(other, _torch(prompt))
    assert torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
    jloss, jprefill = jax.jit(jmodel.loss), jax.jit(jmodel.prefill)
    assert float(jloss(jparams, _jax(batch))) != float(jloss(jother, _jax(batch)))
    ja, jb = jprefill(jparams, _jax(prompt)), jprefill(jother, _jax(prompt))
    assert np.array_equal(np.asarray(ja[0]), np.asarray(jb[0]))
    assert all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(ja[1], jb[1]))


# ---------------------------------------------------------------------------
# Train steps, the loop's loader, the bf16 gradient, the activations' bytes
# ---------------------------------------------------------------------------


def test_three_adamw_steps_match_reference():
    """Three steps of the reduced model (AdamW, float32 moments, remat on)
    on batches that carry frames: the losses and grad norms within rtol
    1e-5, and each parameter leaf's distance from the reference's within
    1e-2 of how far the reference moved it (``tests/test_torch_train.py``'s
    rule: AdamW moves an element whose gradient is float32 noise by up to
    lr in either direction). The zero-gradient leaf's gradient is rounding
    in both packages, so AdamW moves it by its weight decay and by rounding
    over its epsilon: the two within 1% of one step of lr on every
    element."""
    jmodel, jparams, model, params = pair_of_models(ENCDEC, remat=True)
    start = dict(_paths(jax.tree_util.tree_map(np.asarray, jparams)))
    jstep = jax.jit(jmake_train_step(jmodel, lr=1e-3))
    step = make_train_step(model, lr=1e-3)
    jopt, opt = jinit_opt_state(jmodel, jparams), init_opt_state(model, params)
    for i in range(3):
        batch = _batch(model.cfg, 4, 40, model.cfg.frontend_tokens, seed=i)
        jparams, jopt, jm = jstep(jparams, jopt, _jax(batch))
        params, opt, m = step(params, opt, _torch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
    got = dict(_paths(params))
    for path, w in _paths(jax.tree_util.tree_map(np.asarray, jparams)):
        moved = np.linalg.norm(w - start[path])
        assert moved > 0, path
        limit = 1e-2 * (1e-3 * np.sqrt(w.size) if path in ZERO_GRAD else moved)
        assert np.linalg.norm(_np(got[path]) - w) <= limit, path


def test_train_loop_cannot_drive_whisper_in_either_package():
    """The loader yields tokens and labels only, and the loss reads frames:
    both packages' ``train_loop`` raise KeyError for them (the port's names
    what the loss takes)."""
    kw = dict(arch=ENCDEC, steps=1, batch=2, seq=8, log_every=100, print_fn=lambda *a: None)
    with pytest.raises(KeyError, match="frames"):
        jtrain_loop(**kw)
    with pytest.raises(KeyError, match=r"frames: the encdec loss takes precomputed \(B, 32, 64\)"):
        train_loop(device="cpu", **kw)


def _bf16_errors(g16: dict, g32: dict) -> dict[str, float]:
    """chip_smoke's measures of the bf16 gradient against the float32 one:
    each leaf's relative norm error but the cross key bias's, each decoder
    layer's slice of ENC_SLICE_LEAVES, and the size of the cross key bias's
    zero gradient (keyed ``size <leaf>``)."""
    errs, slices, size = cs.encdec_grad_errors(
        {k: torch.tensor(_np(v)) for k, v in g16.items()},
        {k: torch.tensor(_np(v)) for k, v in g32.items()})
    return {**errs, **slices, f"size {cs.ENC_ZERO_GRAD}": size}


BF16_CASES = {  # name: config changes, S
    "reduced-1500-frames": ({"frontend_tokens": 1500}, 64),
    # the published width and heads (768, 12 of 64) at 2 + 2 layers, vocab 1,024
    "width-768-2-layers": ({"frontend_tokens": 1500, "d_model": 768, "n_heads": 12,
                            "n_kv_heads": 12, "d_ff": 3072, "vocab_size": 1024}, 64),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_gradient_error_is_the_reference_s(case, capsys):
    """The bf16 step's gradients against the float32 step's on the same
    bf16 weights (cast up), in each package, by leaf, by decoder layer
    slice and, for the cross key bias's zero gradient, by size: one clip of
    1,500 frames and its loader tokens, on the seed's weights. Each of the
    port's measures lies within twice the reference's own plus
    1e-3 (bf16 rounding lands elsewhere in each package). Both are
    printed: the limits of ``chip_smoke.py``'s enc-dec bf16 check rest on
    them."""
    replace, S = BF16_CASES[case]
    jmodel, jparams, model, params = pair_of_models(ENCDEC, dtype="bfloat16", remat=True,
                                                    **replace)
    np_batch = JTokenLoader(global_batch=1, seq_len=S, vocab=model.cfg.vocab_size,
                            seed=0).batch(100)
    np_batch["frames"] = np.random.default_rng(2).normal(
        size=(1, 1500, model.cfg.d_model)).astype(np.float32)
    jmodel32 = jbuild_model(dataclasses.replace(jmodel.cfg, dtype="float32"))
    model32 = build_model(dataclasses.replace(model.cfg, dtype="float32"))
    jb = _jax(np_batch)
    want = _bf16_errors(
        dict(_paths(jax.jit(jax.grad(jmodel.loss))(jparams, jb))),
        dict(_paths(jax.jit(jax.grad(jmodel32.loss))(
            jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams), jb))))
    tb = _torch(np_batch)
    params32 = jax.tree_util.tree_map(lambda t: t.float(), params)
    got = _bf16_errors(dict(_paths(loss_and_grads(model.loss, params, tb)[1])),
                       dict(_paths(loss_and_grads(model32.loss, params32, tb)[1])))
    with capsys.disabled():
        print(f"\n{case}: bf16 vs float32 gradient, rel norm err by leaf and layer slice, "
              "and the size of the cross key bias's (reference, port): "
              + ", ".join(f"{p} {want[p]:.4g} {got[p]:.4g}" for p in sorted(want)))
    assert sorted(got) == sorted(want)
    for p in want:
        assert got[p] <= 2 * want[p] + 1e-3, (p, got[p], want[p])


def test_sequence_bytes_counts_the_encoder_rows():
    """whisper-small's microbatch is sized with its encoder: each encoder
    layer's kept input over the 1,500 frames and the working set of an
    encoder layer at a 1,500-row query, even beside a 4-token prompt. The
    other families' values are those they had before the enc-dec counted
    its encoder (pinned)."""
    cfg = get_config(ENCDEC)
    as_decoder = dataclasses.replace(cfg, family="dense")
    kept = cfg.encoder_layers * 1500 * cfg.d_model * 2
    encoder_layer = (1500 * (cfg.d_ff * 16 + cfg.d_model * 24)
                     + cfg.n_heads * 512 * 1024 * 4 * 8)
    for S in (4, 448):
        assert sequence_bytes(cfg, S) >= sequence_bytes(as_decoder, S) + kept
    # beside a 4-token prompt, whose own layer takes under a MiB
    assert sequence_bytes(cfg, 4) - sequence_bytes(as_decoder, 4) >= kept + encoder_layer - 2**20
    longer = dataclasses.replace(cfg, frontend_tokens=3000)
    assert sequence_bytes(longer, 448) - sequence_bytes(cfg, 448) >= kept
    assert {(a, S): sequence_bytes(get_config(a), S)
            for a, S in [("qwen2-0.5b", 4096), ("qwen2-0.5b", 1024), ("xlstm-350m", 256),
                         ("xlstm-350m", 1024), ("zamba2-7b", 4096)]} == {
        ("qwen2-0.5b", 4096): 2219311104, ("qwen2-0.5b", 1024): 1782054912,
        ("xlstm-350m", 256): 487849984, ("xlstm-350m", 1024): 557056000,
        ("zamba2-7b", 4096): 27429961728}
