"""The encdec family (whisper-small) against the reference on the CPU.

Reduced whisper (2 encoder and 2 decoder layers, d_model 64, H = KH = 4,
QKV biases, the tanh gelu, 32 frames) in both packages on the reference's
weights (``tests/torch_zoo_pair.py``), driven through the Model API:
``prefill`` with ``frames`` and a decoder prompt, then ``decode`` steps.
Float32 within 1e-5, bfloat16 within 2e-2, as the rest of the zoo; the
sinusoid bit for bit. The reference's quirks are kept and pinned here:
the cross-attention query has no bias and no RoPE, the encoder adds the
sinusoid and also applies RoPE, every norm is an rmsnorm (and the
encoder's final norm weight is drawn like a bias, not set to ones).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtransformer
from repro.models import zoo as jzoo
from repro.serve import ServeEngine as JServeEngine
from repro_torch.models import layers, transformer, zoo
from repro_torch.models.transformer import layer_params
from repro_torch.serve import ServeEngine
from torch_zoo_pair import close, pair_of_models, run_both

ENCDEC = "whisper-small"


@pytest.fixture(scope="module")
def pair():
    return pair_of_models(ENCDEC)


def _batch(cfg, B: int, S: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
        "frames": (rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)) * 0.5
                   ).astype(np.float32),
    }


@pytest.mark.parametrize("S,D", [(32, 64), (1500, 768), (7, 10), (1, 2)])
def test_sinusoid_is_the_references_bit_for_bit(S, D):
    got = zoo._sinusoid(S, D)
    want = jzoo._sinusoid(S, D)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_encoder_forward_matches_the_reference(pair):
    """The encoder stack alone on the same input and positions: non-causal
    attention with RoPE and the MLP, layer by layer."""
    _, jparams, model, params = pair
    cfg = model.cfg
    x = (np.random.default_rng(3).normal(size=(2, 32, cfg.d_model))).astype(np.float32)
    pos = np.arange(32)[None].repeat(2, 0)
    got = transformer.encoder_forward(params["encoder_layers"], torch.tensor(x), cfg,
                                      torch.tensor(pos))
    want = jtransformer.encoder_forward(jparams["encoder_layers"], jnp.asarray(x), cfg,
                                        jnp.asarray(pos))
    close(got, want, 1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_whisper_encode_matches_the_reference(dtype, atol):
    jmodel, jparams, model, params = pair_of_models(ENCDEC, dtype=dtype, seed=1)
    frames = _batch(model.cfg, 2, 1, seed=4)["frames"]
    got = zoo._whisper_encode(params, torch.tensor(frames), model.cfg)
    want = jzoo._whisper_encode(jparams, jnp.asarray(frames), jmodel.cfg)
    assert str(got.dtype)[6:] == str(want.dtype)
    close(got, want, atol)


@pytest.mark.parametrize("S", [1, 4, 24])
def test_prefill_and_three_decode_steps_match_the_reference(pair, S):
    """Logits, the self K/V and the cross K/V within 1e-5 after the prefill
    and after each of three decode steps at ragged lengths."""
    cfg = pair[2].cfg
    batch = _batch(cfg, 3, S, seed=S)
    lengths = np.array([S, max(S - 1, 0), 0], np.int32)
    tl, tc = run_both(pair, batch, cache_len=S + 4, lengths=lengths, steps=3, atol=1e-5)
    kc, vc, xk, xv = tc
    assert tuple(kc.shape) == (cfg.n_layers, 3, S + 4, cfg.n_kv_heads, cfg.hd)
    assert tuple(xk.shape) == (cfg.n_layers, 3, cfg.frontend_tokens, cfg.n_kv_heads, cfg.hd)
    assert float(tl[:, cfg.vocab_size:].max()) == np.float32(-1e30)


def test_bf16_prefill_and_decode_match_the_reference():
    pair = pair_of_models(ENCDEC, dtype="bfloat16", seed=5)
    batch = _batch(pair[2].cfg, 2, 10, seed=8)
    tl, tc = run_both(pair, batch, cache_len=14, lengths=np.array([10, 6]), steps=3,
                      atol=2e-2)
    assert tl.dtype == torch.bfloat16 and all(c.dtype == torch.bfloat16 for c in tc)


def _perturbed(params, leaf: str):
    """The params with every decoder layer's ``xattn`` leaf moved by 1."""
    out = {**params, "layers": {**params["layers"], "xattn": dict(params["layers"]["xattn"])}}
    out["layers"]["xattn"][leaf] = params["layers"]["xattn"][leaf] + 1.0
    return out


def test_cross_query_has_no_bias_and_no_rope(pair):
    """The quirk kept from the reference's prefill and decode: the cross
    query is ``hn @ xattn.wq_col`` alone (``bq_col`` never read, no RoPE),
    while the cross K/V are ``attn_proj_qkv`` of the encoder's output, with
    biases and without RoPE. Moving ``bq_col`` changes no logit in either
    package; moving ``bk_col`` does."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    batch = _batch(cfg, 2, 5, seed=9)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    base, caches = model.prefill(params, tb, cache_len=8)
    assert torch.equal(model.prefill(_perturbed(params, "bq_col"), tb, cache_len=8)[0], base)
    assert not torch.equal(model.prefill(_perturbed(params, "bk_col"), tb, cache_len=8)[0],
                           base)
    jbase = jmodel.prefill(jparams, jb)[0]
    jmoved = {**jparams, "layers": {**jparams["layers"],
                                    "xattn": {**jparams["layers"]["xattn"]}}}
    jmoved["layers"]["xattn"]["bq_col"] = jparams["layers"]["xattn"]["bq_col"] + 1.0
    assert np.array_equal(np.asarray(jmodel.prefill(jmoved, jb)[0]), np.asarray(jbase))
    step = {"tokens": torch.tensor([3, 4], dtype=torch.int32),
            "lengths": torch.tensor([5, 2], dtype=torch.int32)}
    got = model.decode(_perturbed(params, "bq_col"), step,
                       tuple(c.clone() for c in caches))[0]
    assert torch.equal(got, model.decode(params, step, tuple(c.clone() for c in caches))[0])
    # the cross caches: the encoder's output projected with biases, no RoPE
    enc = zoo._whisper_encode(params, tb["frames"], cfg)
    lp = layer_params(params["layers"], 1)
    _, k, v = layers.attn_proj_qkv(lp["xattn"], enc, cfg)
    assert torch.equal(caches[2][1], k) and torch.equal(caches[3][1], v)
    hn = torch.randn(2, 3, cfg.d_model)
    assert torch.equal(zoo._cross_query(lp, hn, cfg),
                       (hn @ lp["xattn"]["wq_col"]).reshape(2, 3, cfg.n_heads, cfg.hd))


def test_encoder_adds_the_sinusoid_and_applies_rope(pair, monkeypatch):
    """The quirk kept from the reference: the encoder's input is frames plus
    the sinusoid, and its attention also rotates q and k at the frames'
    positions (``rope_theta`` 1e4 > 0): two rotations an encoder layer,
    and without RoPE the output differs. Its final norm is an rmsnorm by
    ``enc_final_norm``."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    frames = torch.tensor(_batch(cfg, 2, 1, seed=6)["frames"])
    rotated = []
    real_rope = layers.rope
    monkeypatch.setattr(layers, "rope", lambda x, positions, theta: (
        rotated.append((tuple(x.shape), positions[0].tolist(), theta))
        or real_rope(x, positions, theta)))
    got = zoo._whisper_encode(params, frames, cfg)
    F = cfg.frontend_tokens
    shape = (2, F, cfg.n_heads, cfg.hd)
    assert rotated == [(shape, list(range(F)), 1e4)] * (2 * cfg.encoder_layers)
    monkeypatch.setattr(layers, "rope", real_rope)
    h = frames + torch.from_numpy(zoo._sinusoid(cfg.frontend_tokens, cfg.d_model))[None]
    pos = torch.arange(cfg.frontend_tokens)[None].expand(2, -1)
    enc = transformer.encoder_forward(params["encoder_layers"], h, cfg, pos)
    assert torch.equal(got, layers.rmsnorm(enc, params["enc_final_norm"], cfg.norm_eps))
    no_rope = dataclasses.replace(cfg, rope_theta=0.0)
    assert not torch.equal(zoo._whisper_encode(params, frames, no_rope), got)
    close(got, jzoo._whisper_encode(jparams, jnp.asarray(frames.numpy()), jmodel.cfg), 1e-5)


def test_norms_are_rmsnorm_and_the_encoders_final_norm_is_drawn():
    """Same leaves, shapes and dtypes as the reference's init. Norms are
    rmsnorm weights; ``ln1``/``ln2``/``ln_x``/``final_norm`` are ones, and
    ``enc_final_norm``, which the reference's init does not name among its
    norms, is drawn N(0, 0.02) like a bias, in both packages."""
    jmodel, jparams, model, _ = pair_of_models(ENCDEC, dtype="bfloat16")
    assert model.shapes == jmodel.shapes
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    jflat = {"/".join(str(k.key) for k in path): v
             for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert model.leaves.keys() == jflat.keys()
    for path, t in model.leaves.items():
        assert tuple(t.shape) == jflat[path].shape and t.dtype == torch.bfloat16, path
    for name in ("ln1", "ln2", "ln_x"):
        assert bool(params["layers"][name].eq(1).all())
        assert np.all(np.asarray(jparams["layers"][name], np.float32) == 1)
    assert bool(params["encoder_layers"]["ln1"].eq(1).all())
    for enc_norm in (params["enc_final_norm"].float().numpy(),
                     np.asarray(jparams["enc_final_norm"], np.float32)):
        assert abs(float(enc_norm.std()) - 0.02) < 0.01 and abs(float(enc_norm.mean())) < 0.01


def test_params_from_jax_keeps_the_new_leaves_bits():
    """The encoder's stacked leaves, the cross attention's weights and
    biases and the encoder's final norm, bit for bit in bfloat16."""
    _, jparams, _, params = pair_of_models(ENCDEC, dtype="bfloat16", seed=2)
    leaves = [("encoder_layers", "attn", "wq_col"), ("encoder_layers", "mlp", "wu_col"),
              ("layers", "xattn", "bq_col"), ("layers", "xattn", "bk_col"),
              ("layers", "xattn", "bv_col"), ("layers", "xattn", "wo_row"),
              ("layers", "ln_x"), ("enc_final_norm",)]
    for path in leaves:
        got, want = params, jparams
        for k in path:
            got, want = got[k], want[k]
        want = np.asarray(want)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape, path
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16)), path


def test_full_cache_raises_before_the_write(pair):
    """The reference's decode at ``lengths == cache_len`` drops its scatter
    silently (``tests/test_models_smoke.py`` relies on it); the port raises
    ValueError before it writes, and leaves every cache as it was."""
    jmodel, jparams, model, params = pair
    batch = _batch(model.cfg, 2, 6, seed=10)
    jl, jc = jmodel.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    step = {"tokens": np.zeros(2, np.int32), "lengths": np.array([6, 6], np.int32)}
    jl2, jc2 = jmodel.decode(jparams, {k: jnp.asarray(v) for k, v in step.items()}, jc)
    assert np.isfinite(np.asarray(jl2)).all()
    assert np.array_equal(np.asarray(jc2[0]), np.asarray(jc[0]))  # the rows were dropped
    _, tc = model.prefill(params, {k: torch.tensor(v) for k, v in batch.items()})
    before = [c.clone() for c in tc]
    with pytest.raises(ValueError, match="a decode step over a cache of 6 rows"):
        model.decode(params, {k: torch.tensor(v) for k, v in step.items()}, tc)
    assert all(torch.equal(a, b) for a, b in zip(tc, before))


def test_prefill_without_frames_raises_in_both_packages(pair):
    jmodel, jparams, model, params = pair
    with pytest.raises(KeyError, match="frames"):
        jmodel.prefill(jparams, {"tokens": jnp.zeros((1, 4), jnp.int32)})
    with pytest.raises(KeyError, match=r"frames.*\(B, 32, 64\)"):
        model.prefill(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


def test_both_serve_engines_refuse_the_encdec(pair):
    jmodel, jparams, model, params = pair
    with pytest.raises(NotImplementedError):
        JServeEngine(jmodel, jparams)
    with pytest.raises(NotImplementedError, match=r"refused, as by the reference.*frames"):
        ServeEngine(model, params, device="cpu")


def test_attention_reaches_the_kernels_entry_points(pair, monkeypatch):
    """Prefill: per decoder layer one causal self-attention and one
    non-causal cross-attention over every encoder row, per encoder layer
    one non-causal call; decode: per layer a self call at lengths + 1 and a
    cross call at the encoder's length, as the card's launch counts
    expect."""
    _, _, model, params = pair
    cfg = model.cfg
    calls = []
    real_flash, real_decode = layers.flash_attention_op, layers.decode_attention_op

    def flash(q, k, v, **kw):
        calls.append(("flash", q.shape[1], k.shape[1], kw["causal"]))
        return real_flash(q, k, v, **kw)

    def decode(q, kc, vc, lengths, **kw):
        calls.append(("decode", kc.shape[1], tuple(lengths.tolist())))
        return real_decode(q, kc, vc, lengths, **kw)

    monkeypatch.setattr(layers, "flash_attention_op", flash)
    monkeypatch.setattr(layers, "decode_attention_op", decode)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg, 2, 4, seed=11).items()}
    _, caches = model.prefill(params, batch, cache_len=6)
    F = cfg.frontend_tokens
    assert calls == ([("flash", F, F, False)] * cfg.encoder_layers
                     + [("flash", 4, 4, True), ("flash", 4, F, False)] * cfg.n_layers)
    calls.clear()
    model.decode(params, {"tokens": torch.tensor([1, 2], dtype=torch.int32),
                          "lengths": torch.tensor([4, 1], dtype=torch.int32)}, caches)
    assert calls == [("decode", 6, (5, 2)), ("decode", F, (F, F))] * cfg.n_layers
