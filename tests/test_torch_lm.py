"""The port's dense LM and its serve engine against the reference on the CPU.

Both packages get the same weights: the reference's ``model.init`` draws
them and ``params_from_jax`` carries them over. Configs are the reduced
granite-3-8b and qwen2-0.5b (which has QKV bias), in float32. Prefill and
decode logits and caches agree within ``atol=1e-5``; served tokens are
identical.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models.base import SHAPES as JSHAPES
from repro.models.base import param_count as jparam_count
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import build_model, layers, param_count, zoo
from repro_torch.models.base import SHAPES
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine

DENSE = ["granite-3-8b", "qwen2-0.5b"]


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(reference model, its params, port model, the same params)."""
    name = request.param
    jmodel = jbuild_model(jreduced_config(name))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(reduced_config(name))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, model, params


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_configs_and_param_counts_equal_the_reference(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(jget_config(name))
    assert (dataclasses.asdict(reduced_config(name))
            == dataclasses.asdict(jreduced_config(name)))
    assert param_count(get_config(name)) == jparam_count(jget_config(name))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("name", ARCHS)
def test_shape_trees_equal_the_reference(name):
    """Full published widths, every config of the registry: shapes only,
    nothing allocated."""
    assert build_model(get_config(name)).shapes == jbuild_model(jget_config(name)).shapes


@pytest.mark.parametrize("name", ARCHS)
def test_build_model_builds_every_config_of_the_registry(name):
    """Every family of the reference's registry is built (no family is left
    unported): the reduced config's model has the reference's shape tree
    and a loss, prefill and decode of its family."""
    model = build_model(reduced_config(name))
    assert model.cfg.family in zoo._FAMILIES
    assert model.shapes == jbuild_model(jreduced_config(name)).shapes
    assert (model._loss, model._prefill, model._decode) == zoo._FAMILIES[model.cfg.family][1:]


# ---------------------------------------------------------------------------
# Layers at the reference's bf16 rounding points
# ---------------------------------------------------------------------------


def _bf16_pair(rng, shape, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)


def _bits_agree(got: torch.Tensor, want) -> float:
    """Share of elements whose bfloat16 bits are equal."""
    g = got.view(torch.int16).numpy()
    w = np.asarray(want).view(np.int16)
    return float((g == w).mean())


def test_layers_round_bf16_where_the_reference_does():
    """rmsnorm (float32, cast, times the weight in bfloat16), rope (float32,
    cast back) and the gated MLP (silu in float32) in bfloat16: at least
    99% of the elements bit for bit equal to the reference's, the rest a
    last-bit rounding apart (transcendentals differ in the last float32 bit
    between the two libraries). Rounding at another place would leave far
    fewer equal."""
    rng = np.random.default_rng(0)
    cfg = reduced_config("granite-3-8b", dtype="bfloat16")
    jx, x = _bf16_pair(rng, (2, 16, 64))
    jw, w = _bf16_pair(rng, (64,), 0.5)
    assert _bits_agree(layers.rmsnorm(x, w, 1e-5), jlayers.rmsnorm(jx, jw, 1e-5)) >= 0.99
    jh, h = _bf16_pair(rng, (2, 16, 4, 16))
    pos = np.arange(16)[None].repeat(2, 0)
    assert _bits_agree(layers.rope(h, torch.tensor(pos), 1e6),
                       jlayers.rope(jh, jnp.asarray(pos), 1e6)) >= 0.99
    p = {}
    jp = {}
    for name, shape in (("wg_col", (64, 128)), ("wu_col", (64, 128)), ("wd_row", (128, 64))):
        jp[name], p[name] = _bf16_pair(rng, shape, 0.1)
    assert _bits_agree(layers.mlp_block(p, x, cfg), jlayers.mlp_block(jp, jx, cfg)) >= 0.99


def _f32_pair(rng, shape, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.tensor(x)


@pytest.mark.parametrize("tp_pad_heads", [0, 6])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_block_matches_the_reference(tp_pad_heads, causal):
    """``attn_block`` in float32 within 1e-5, with the heads as they are
    and repeated and zero-padded to 6 by ``expand_heads_for_tp``."""
    cfg = dataclasses.replace(reduced_config("qwen2-0.5b"), tp_pad_heads=tp_pad_heads)
    jcfg = dataclasses.replace(jreduced_config("qwen2-0.5b"), tp_pad_heads=tp_pad_heads)
    rng = np.random.default_rng(5)
    jp, p = {}, {}
    for name, shape in (("wq_col", (64, 64)), ("wk_col", (64, 32)), ("wv_col", (64, 32)),
                        ("wo_row", (64, 64)), ("bq_col", (64,)), ("bk_col", (32,)),
                        ("bv_col", (32,))):
        jp[name], p[name] = _f32_pair(rng, shape, 0.1)
    jx, x = _f32_pair(rng, (2, 24, 64))
    pos = np.arange(24)[None].repeat(2, 0)
    got = layers.attn_block(p, x, cfg, positions=torch.tensor(pos), causal=causal)
    want = jlayers.attn_block(jp, jx, jcfg, positions=jnp.asarray(pos), causal=causal)
    _close(got, want)


def test_gelu_mlp_embedding_and_logits_match_the_reference():
    """The MLP's gelu form (the reference's tanh approximation), the token
    embedding and the logits in float32, within 1e-5."""
    cfg = dataclasses.replace(reduced_config("granite-3-8b"), mlp_act="gelu")
    rng = np.random.default_rng(6)
    jp, p = {}, {}
    for name, shape in (("wu_col", (64, 128)), ("wd_row", (128, 64))):
        jp[name], p[name] = _f32_pair(rng, shape, 0.1)
    jx, x = _f32_pair(rng, (2, 8, 64))
    _close(layers.mlp_block(p, x, cfg), jlayers.mlp_block(jp, jx, cfg))
    jemb, emb = _f32_pair(rng, (128, 64))
    toks = rng.integers(0, 128, size=(2, 8))
    _close(layers.embed_tokens(emb, torch.tensor(toks)),
           jlayers.embed_tokens(jemb, jnp.asarray(toks)))
    jout, out = _f32_pair(rng, (64, 128))
    _close(layers.lm_logits(x, out), jlayers.lm_logits(jx, jout))


# ---------------------------------------------------------------------------
# Prefill and decode against the reference, float32
# ---------------------------------------------------------------------------


def test_prefill_and_three_decode_steps_match_the_reference(pair):
    """Logits and caches within 1e-5 after prefill and after each of three
    decode steps (the port writes its caches in place)."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache_len=24)
    tl, tc = model.prefill(params, {"tokens": torch.tensor(toks)}, cache_len=24)
    assert tl.shape == (3, 256) and tc[0].shape == (cfg.n_layers, 3, 24, cfg.n_kv_heads, cfg.hd)
    _close(tl, jl)
    for a, b in zip(tc, jc):
        _close(a, b)
    lengths = np.full(3, 12, np.int32)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for _ in range(3):
        batch = {"tokens": tok, "lengths": lengths}
        jl, jc = jmodel.decode(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
        tl, tc = model.decode(params, {k: torch.tensor(v) for k, v in batch.items()}, tc)
        _close(tl, jl)
        for a, b in zip(tc, jc):
            _close(a, b)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        lengths = lengths + 1
    assert float(tl[:, cfg.vocab_size:].max()) == np.float32(-1e30)  # padded vocab masked


# ---------------------------------------------------------------------------
# ServeEngine: the reference's serving tests, token for token
# ---------------------------------------------------------------------------


def _serve(engine_cls, model, params, n_slots, cache_len, requests, **kw):
    eng = engine_cls(model, params, n_slots=n_slots, cache_len=cache_len, **kw)
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in requests]
    done = eng.run(max_ticks=200)
    return [r.output for r in reqs], [r.rid for r in done]


@pytest.mark.parametrize("n_slots,cache_len,requests", [
    (2, 64, [([1, 2, 3], 5)] * 5),  # batches and finishes
    (1, 64, [([5, 6, 7], 4)]),  # matches the stepwise oracle
    (2, 48, [([i + 1], 3) for i in range(6)]),  # recycles slots
    (3, 40, [(list(range(7, 7 + n)), 3 + n % 5) for n in (1, 30, 9, 40, 2, 17, 5)]),
], ids=["batches", "stepwise", "recycles", "mixed"])
def test_serve_engine_tokens_equal_the_reference(pair, n_slots, cache_len, requests):
    """The reference's serving tests (``tests/test_train_serve.py``) plus a
    mix of prompt lengths, some longer than ``prefill_len`` and some running
    into ``cache_len``: the same outputs token for token, finishing in the
    same order."""
    jmodel, jparams, model, params = pair
    want = _serve(JServeEngine, jmodel, jparams, n_slots, cache_len, requests)
    got = _serve(ServeEngine, model, params, n_slots, cache_len, requests, device="cpu")
    assert got == want
    assert all(len(o) >= 1 for o in got[0])


def test_serve_engine_matches_the_port_stepwise(pair):
    """Engine output == the port's own prefill + decode with the same
    padding (the reference's stepwise-oracle test, on the port)."""
    _, _, model, params = pair
    eng = ServeEngine(model, params, n_slots=1, cache_len=64, device="cpu")
    prompt = [5, 6, 7]
    r = eng.submit(prompt, max_new_tokens=4)
    eng.run(max_ticks=50)
    P = eng.prefill_len
    toks = torch.zeros((1, P), dtype=torch.int32)
    toks[0, P - len(prompt):] = torch.tensor(prompt)
    logits, caches = model.prefill(params, {"tokens": toks}, cache_len=64)
    out = [int(logits.argmax(-1)[0])]
    lengths = torch.tensor([P], dtype=torch.int32)
    for _ in range(3):
        lg, caches = model.decode(
            params, {"tokens": torch.tensor([out[-1]], dtype=torch.int32),
                     "lengths": lengths}, caches)
        out.append(int(lg.argmax(-1)[0]))
        lengths = lengths + 1
    assert r.output == out


# ---------------------------------------------------------------------------
# Parameters and devices
# ---------------------------------------------------------------------------


def test_params_from_jax_keeps_bf16_bits():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)), jnp.bfloat16)
    got = params_from_jax({"a": {"b": np.asarray(x)}}, device="cpu")["a"]["b"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(x).view(np.int16))


def test_init_matches_the_reference_layout_and_scales():
    """Same leaves, shapes and dtypes as the reference's init; norms are
    ones; each weight's spread is its reference scale."""
    cfg = reduced_config("granite-3-8b", dtype="bfloat16")
    jparams = jbuild_model(jreduced_config("granite-3-8b", dtype="bfloat16")).init(
        jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    flat = {tuple(jax.tree_util.DictKey(k) for k in path.split("/")): v
            for path, v in ((p, t.data) for p, t in model.leaves.items())}
    assert flat.keys() == jflat.keys()
    for key, t in flat.items():
        assert tuple(t.shape) == jflat[key].shape and t.dtype == torch.bfloat16
    assert params["layers"]["ln1"].eq(1).all() and params["final_norm"].eq(1).all()
    std = float(params["layers"]["mlp"]["wd_row"].float().std())
    assert abs(std - min(0.02, (1 / cfg.d_ff) ** 0.5)) < 2e-3  # fan-in 128: 0.02
    assert abs(float(params["embed"].float().std()) - 0.02) < 2e-3


def test_init_needs_a_generator_on_the_device():
    model = build_model(reduced_config("granite-3-8b"))
    with pytest.raises(ValueError, match="Generator"):
        model.init(torch.Generator(), device="meta")


def test_default_device_is_the_card():
    """Without a card, init and the engine with the default device raise
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    model = build_model(reduced_config("granite-3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator())
    params = model.init(torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"a": np.zeros(2, np.float32)})
