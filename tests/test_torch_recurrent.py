"""The recurrent families (ssm: xlstm-350m; hybrid: zamba2-7b) and the
sliding window, against the reference on the CPU.

Both packages get the same weights: the reference's ``model.init`` draws
them and ``params_from_jax`` carries them over. Configs are the reduced
``xlstm-350m`` and ``zamba2-7b`` (float32; the reduced hybrid has a window
of 64), driven through the Model API the reference's tests drive:
``build_model`` → ``prefill`` → ``decode`` steps. Prompts of 96 tokens let
the window bite. Float32 logits and caches agree within ``atol=1e-5`` (as
``tests/test_torch_lm.py`` holds the dense LM), bfloat16 within ``2e-2``.
As in the reference, the recurrent prefills return zeroed state, so a
decode after a prefill starts from zero state in both packages.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models.base import ShapeSpec
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import reduced_config
from repro_torch.kernels import ref
from repro_torch.models import build_model, layers
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine

RECURRENT = ["xlstm-350m", "zamba2-7b"]


def _pair_of_models(name: str, dtype: str = "float32", seed: int = 0):
    """(reference model, its params, port model, the same params)."""
    jmodel = jbuild_model(jreduced_config(name, dtype=dtype))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = build_model(reduced_config(name, dtype=dtype))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module", params=RECURRENT)
def pair(request):
    return _pair_of_models(request.param)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _run_both(pair, toks: np.ndarray, steps: int, atol: float = 1e-5):
    """Prefill ``toks`` in both packages, then ``steps`` greedy decode steps
    (the reference's tokens fed to both), holding logits and every cache
    after each; returns the port's last logits and caches."""
    jmodel, jparams, model, params = pair
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill(params, {"tokens": torch.tensor(toks)})
    assert tl.shape == jl.shape and len(tc) == len(jc)
    _close(tl, jl, atol)
    for a, b in zip(tc, jc):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
        _close(a, b, atol)
    B, S = toks.shape
    lengths = np.full(B, S, np.int32)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(steps):
        batch = {"tokens": tok, "lengths": lengths}
        jl, jc = jmodel.decode(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
        tl, tc = model.decode(params, {k: torch.tensor(v) for k, v in batch.items()}, tc)
        _close(tl, jl, atol)
        for a, b in zip(tc, jc):
            _close(a, b, atol)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        lengths = lengths + 1
    return tl, tc


# ---------------------------------------------------------------------------
# Shapes, init, conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RECURRENT)
def test_reduced_shape_trees_equal_the_reference(name):
    assert (build_model(reduced_config(name)).shapes
            == jbuild_model(jreduced_config(name)).shapes)


@pytest.mark.parametrize("name", RECURRENT)
def test_init_matches_the_reference_layout_and_dtypes(name):
    """bf16: the same leaves and shapes as the reference's init; norms and
    ``d_skip`` ones, ``dt_bias`` and ``a_log`` float32 zeros, the rest
    bf16 with the reference's spread; the stacked ``mlayers``/``slayers``
    too, drawn a layer at a time."""
    jparams = jbuild_model(jreduced_config(name, dtype="bfloat16")).init(jax.random.PRNGKey(0))
    model = build_model(reduced_config(name, dtype="bfloat16"))
    model.init(torch.Generator().manual_seed(0), device="cpu")
    jflat = {"/".join(str(k.key) for k in path): v
             for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert model.leaves.keys() == jflat.keys()
    for path, t in model.leaves.items():
        want = jflat[path]
        assert tuple(t.shape) == want.shape and str(t.dtype)[6:] == str(want.dtype), path
        name_ = path.split("/")[-1]
        if name_ in ("ln", "ln1", "ln2", "final_norm", "d_skip"):
            assert bool(t.eq(1).all()), path
        elif name_ in ("dt_bias", "a_log"):
            assert t.dtype == torch.float32 and not bool(t.any()), path
        else:
            fan_in = t.shape[-2] if t.dim() >= 2 else t.shape[-1]
            scale = 0.02 if t.dim() < 2 else min(0.02, (1.0 / fan_in) ** 0.5)
            assert abs(float(t.float().std()) - scale) < 0.25 * scale, path


@pytest.mark.parametrize("name", RECURRENT)
def test_params_from_jax_keeps_the_float32_leaves_of_a_bf16_model(name):
    jparams = jbuild_model(jreduced_config(name, dtype="bfloat16")).init(jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    for path, want in flat.items():
        got = params
        for k in path:
            got = got[k.key]
        assert str(got.dtype)[6:] == str(want.dtype)
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    if name == "zamba2-7b":
        assert params["layers"]["a_log"].dtype == torch.float32
        assert params["shared"]["attn"]["wq_col"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", RECURRENT)
def test_zero_state_matches_the_reference_decode_specs(name):
    """The prefill's zeroed caches have the shapes and dtypes of the
    reference's decode inputs (``input_specs``) at the prompt's length, the
    hybrid's K/V ring of min(S, window) rows."""
    jmodel, _, model, params = _pair_of_models(name)
    for S in (16, 96):
        _, caches = model.prefill(params, {"tokens": torch.zeros((2, S), dtype=torch.int32)})
        specs = jmodel.input_specs(ShapeSpec("d", "decode", S, 2))
        want = [v for k, v in specs.items() if k not in ("tokens", "lengths")]
        assert [tuple(c.shape) for c in caches] == [w.shape for w in want]
        assert [str(c.dtype)[6:] for c in caches] == [str(w.dtype) for w in want]
        # zeros, and xlstm's sLSTM stabilisers at -30
        assert all(torch.unique(c).tolist() in ([0.0], [-30.0]) for c in caches)


# ---------------------------------------------------------------------------
# Prefill and decode against the reference, float32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [32, 96], ids=["inside-the-window", "past-the-window"])
def test_prefill_and_four_decode_steps_match_the_reference(pair, S):
    """Logits and every cache within 1e-5 after the prefill and after each
    of four decode steps (the port writes its caches in place); at S = 96
    the hybrid's prefill window of 64 masks the oldest keys."""
    rng = np.random.default_rng(S)
    cfg = pair[2].cfg
    toks = rng.integers(0, cfg.vocab_size, size=(3, S)).astype(np.int32)
    tl, _ = _run_both(pair, toks, steps=4)
    assert float(tl[:, cfg.vocab_size:].max()) == np.float32(-1e30)  # padded vocab masked


def test_zamba_decode_wraps_its_ring_buffer():
    """A prompt of 60 tokens leaves a ring of 60 rows: eight decode steps
    write rows 60 mod 60 = 0 onward, over the prompt's zeroed rows, each
    against the reference."""
    pair = _pair_of_models("zamba2-7b", seed=2)
    toks = np.random.default_rng(60).integers(0, 128, size=(2, 60)).astype(np.int32)
    _, caches = _run_both(pair, toks, steps=8)
    assert caches[2].shape[2] == 60 and bool(caches[2][:, :, :8].any())


@pytest.mark.parametrize("name", RECURRENT)
def test_bf16_prefill_and_decode_match_the_reference(name):
    """bfloat16 within 2e-2 over a 40-token prompt and two decode steps
    (the reference's XLA keeps some intermediates in float32)."""
    pair = _pair_of_models(name, dtype="bfloat16", seed=5)
    toks = np.random.default_rng(40).integers(0, 128, size=(2, 40)).astype(np.int32)
    _run_both(pair, toks, steps=2, atol=2e-2)


@pytest.mark.parametrize("name", RECURRENT)
def test_prefill_equals_decoding_the_prompt_from_zero_state(name):
    """The port's own recurrence check, the one ``chip_smoke.py`` makes at
    full width on the card: a 40-token prompt prefilled, and decoded one
    token at a time from the zeroed caches of a 40-row prefill; the last
    logits agree within 1e-4 (the chunked and the step forms sum in other
    orders)."""
    model = build_model(reduced_config(name))
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    if name == "zamba2-7b":  # draw the Mamba2 decays too (init makes them zeros)
        params["layers"]["a_log"].normal_(generator=torch.Generator().manual_seed(2))
        params["layers"]["dt_bias"].normal_(generator=torch.Generator().manual_seed(3))
    toks = torch.tensor(np.random.default_rng(4).integers(0, 128, size=(2, 40)),
                        dtype=torch.int32)
    want, caches = model.prefill(params, {"tokens": toks})
    for t in range(40):
        got, caches = model.decode(params, {"tokens": toks[:, t],
                                            "lengths": torch.full((2,), t, dtype=torch.int32)},
                                   caches)
    _close(got, want.numpy(), 1e-4)


# ---------------------------------------------------------------------------
# The sliding window
# ---------------------------------------------------------------------------


def _f32(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.tensor(x)


@pytest.mark.parametrize("window", [1, 16, 64])
@pytest.mark.parametrize("G", [1, 2], ids=["G=1", "GQA"])
def test_attention_chunked_window_matches_the_reference(G, window):
    """``attention_chunked(window=)`` on the plain version against the
    reference's over S = 96 > window, causal, with the reference's chunks
    (32 queries, 48 keys) so its online softmax crosses the window's edge."""
    rng = np.random.default_rng(window * 10 + G)
    jq, q = _f32(rng, (2, 96, 2 * G, 16))
    jk, k = _f32(rng, (2, 96, 2, 16))
    jv, v = _f32(rng, (2, 96, 2, 16))
    got = layers.attention_chunked(q, k, v, causal=True, window=window)
    want = jlayers.attention_chunked(jq, jk, jv, causal=True, window=window,
                                     q_chunk=32, k_chunk=48)
    _close(got, want)
    if window < 96:
        assert float((got - layers.attention_chunked(q, k, v, causal=True)).abs().max()) > 1e-3


@pytest.mark.parametrize("window", [8, 40])
def test_attention_chunked_window_without_causal_matches_the_reference(window):
    rng = np.random.default_rng(window)
    jq, q = _f32(rng, (1, 50, 4, 8))
    jk, k = _f32(rng, (1, 50, 4, 8))
    jv, v = _f32(rng, (1, 50, 4, 8))
    got = layers.attention_chunked(q, k, v, causal=False, window=window)
    _close(got, jlayers.attention_chunked(jq, jk, jv, causal=False, window=window))


def test_flash_attention_ref_window_offset_by_skv_minus_sq():
    """With Sq < Skv the window sits at the queries' positions Skv − Sq + i,
    as the reference's mask with q_offset = Skv − Sq."""
    rng = np.random.default_rng(12)
    jq, q = _f32(rng, (2, 20, 4, 16))
    jk, k = _f32(rng, (2, 70, 2, 16))
    jv, v = _f32(rng, (2, 70, 2, 16))
    got = ref.flash_attention_ref(q, k, v, causal=True, window=24)
    want = jlayers.attention_chunked(jq, jk, jv, causal=True, window=24, q_offset=50)
    _close(got, want)
    assert torch.equal(ref.flash_attention_ref(q, k, v, causal=True, window=70),
                       ref.flash_attention_ref(q, k, v, causal=True))


# ---------------------------------------------------------------------------
# What the families are driven through, and what still raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", RECURRENT)
def test_both_serve_engines_refuse_the_recurrent_families(name):
    """The reference's ServeEngine drives KV-cache decoder LMs only; the
    port's refuses the same families (they are driven through prefill and
    decode)."""
    jmodel, jparams, model, params = _pair_of_models(name)
    with pytest.raises(NotImplementedError):
        JServeEngine(jmodel, jparams)
    with pytest.raises(NotImplementedError, match="refused, as by the reference"):
        ServeEngine(model, params, device="cpu")


def test_not_ported_names_only_what_still_raises():
    """Every family of the registry is ported: ``build_model`` refuses only
    a family the reference does not have."""
    from repro_torch.models import zoo

    assert not hasattr(zoo, "_NOT_PORTED")
    assert sorted(zoo._FAMILIES) == ["dense", "encdec", "hybrid", "moe", "ssm", "vlm"]
    cfg = dataclasses.replace(reduced_config("granite-3-8b"), family="rnn")
    with pytest.raises(ValueError, match="rnn"):
        build_model(cfg)
