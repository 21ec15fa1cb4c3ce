"""The port's moe family against the reference on the CPU.

``moe_ffn`` (``repro_torch.models.moe``) against ``repro.models.moe.moe_ffn``
on the same seeded weights and inputs: reduced qwen2-moe-a2.7b (shared
experts, 8 experts padded to 64) and arctic-480b (dense residual), both
dispatch variants, prefill shapes longer than one token block and the
decode shape ``(B, 1, D)``. Tolerances: float32 ``rtol=1e-5, atol=1e-6``;
bfloat16 ``atol=2e-2`` (the attention tests' bfloat16 tolerance: the
reference compiles its scanned block body, and XLA keeps some of its
intermediates in float32, so bits cannot be compared). Then the cases that
decide which assignments survive: a skewed router that makes the reference
drop assignments for capacity, padded experts that are never routed, and
exact gate ties resolved as ``jax.lax.top_k`` resolves them. Then the
reduced models whole: prefill logits and caches and three decode steps
within ``atol=1e-5``, and ``ServeEngine`` tokens equal to the reference
engine's.
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
from repro.models.moe import moe_ffn as jmoe_ffn
from repro.models.moe import moe_param_shapes as jmoe_param_shapes
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.moe import _capacity, _route, moe_ffn, moe_param_shapes, route
from repro_torch.serve import ServeEngine

MOE = ["qwen2-moe-a2.7b", "arctic-480b"]
DISPATCH = ["einsum", "scatter"]


def _cfgs(name: str, dispatch: str = "einsum", dtype: str = "float32", **kw):
    jcfg = dataclasses.replace(jreduced_config(name, dtype=dtype), moe_dispatch=dispatch, **kw)
    cfg = dataclasses.replace(reduced_config(name, dtype=dtype), moe_dispatch=dispatch, **kw)
    return jcfg, cfg


def _weights(cfg, seed: int = 0, router_scale: float = 0.5) -> dict:
    """Seeded float32 weights: the router wide enough that routing is
    decisive, every other leaf at 1/sqrt(fan_in)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * (router_scale if k == "router_col"
                                      else 1 / np.sqrt(s[-2]))).astype(np.float32)
            for k, s in jmoe_param_shapes(cfg).items()}


def _run(jcfg, cfg, w: dict, x: np.ndarray, token_block: int, dtype=np.float32):
    """(port, reference) outputs of moe_ffn as float32 numpy."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jmoe_ffn({k: jnp.asarray(v, jdt) for k, v in w.items()}, jnp.asarray(x, jdt),
                    jcfg, token_block=token_block)
    got = moe_ffn({k: torch.tensor(v).to(tdt) for k, v in w.items()},
                  torch.tensor(x).to(tdt), cfg, token_block=token_block)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


# (B, S) and token_block: several blocks with a padded tail, one block, a
# decode tick's (B, 1)
SHAPES = [((2, 24), 16), ((3, 20), 4096), ((16, 1), 4096)]


def test_param_shapes_equal_the_reference():
    for name in MOE:
        jcfg, cfg = _cfgs(name)
        assert moe_param_shapes(cfg) == jmoe_param_shapes(jcfg)


@pytest.mark.parametrize("shape,token_block", SHAPES, ids=["blocks", "one-block", "decode"])
@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_matches_the_reference_f32(name, dispatch, shape, token_block):
    jcfg, cfg = _cfgs(name, dispatch)
    x = np.random.default_rng(1).normal(size=(*shape, cfg.d_model)).astype(np.float32)
    got, want = _run(jcfg, cfg, _weights(jcfg), x, token_block)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_matches_the_reference_bf16(name, dispatch):
    jcfg, cfg = _cfgs(name, dispatch, dtype="bfloat16")
    rng = np.random.default_rng(2)
    for shape, token_block in SHAPES:
        x = (rng.normal(size=(*shape, cfg.d_model)) * 0.5).astype(np.float32)
        got, want = _run(jcfg, cfg, _weights(jcfg), x, token_block, dtype="bfloat16")
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


def _skewed(jcfg, seed: int = 3):
    """Weights and inputs where the first expert wins almost every token:
    column 0 of the router reads feature 0, which every token holds
    large."""
    w = _weights(jcfg, seed)
    w["router_col"][0, 0] = 40.0
    x = np.random.default_rng(seed).normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    x[..., 0] = 3.0
    return w, x


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("name", MOE)
def test_a_skewed_router_drops_what_the_reference_drops(name, dispatch):
    """The reference drops assignments here (its output with capacity
    factor 1.25 differs from its output with room for every assignment),
    and the port's output equals it; the port's routing shows the drops."""
    jcfg, cfg = _cfgs(name, dispatch)
    w, x = _skewed(jcfg)
    got, want = _run(jcfg, cfg, w, x, token_block=16)
    jroomy, roomy = _cfgs(name, dispatch, moe_capacity_factor=100.0)
    _, want_roomy = _run(jroomy, roomy, w, x, token_block=16)
    assert np.abs(want - want_roomy).max() > 1e-2  # the reference dropped
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    tw, tx = {k: torch.tensor(v) for k, v in w.items()}, torch.tensor(x)
    experts, kept = route(tw, tx, cfg, token_block=16)
    assert kept.shape == experts.shape == (3, 16, cfg.moe_top_k)  # 24 positions in 3 blocks
    assert 0 < int((~kept).sum()) < kept.numel()
    assert bool(route(tw, tx, roomy, token_block=16)[1].all())


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_padded_experts_are_never_routed(dispatch):
    """qwen2-moe's reduced config pads 8 experts to 64. The padded columns
    of the router are made the largest; no token goes to them, and the
    output equals the reference's."""
    jcfg, cfg = _cfgs("qwen2-moe-a2.7b", dispatch)
    w = _weights(jcfg, seed=4)
    E = w["router_col"].shape[1]
    assert E == 64 and cfg.moe_experts == 8
    w["router_col"][:, cfg.moe_experts:] = 50.0
    x = np.abs(np.random.default_rng(4).normal(size=(2, 12, cfg.d_model))).astype(np.float32)
    _, topi, _, _ = _route(torch.tensor(x.reshape(-1, cfg.d_model)),
                           torch.tensor(w["router_col"]), cfg.moe_experts,
                           cfg.moe_top_k, _capacity(24, cfg.moe_top_k, 8, 1.25))
    assert int(topi.max()) < cfg.moe_experts
    got, want = _run(jcfg, cfg, w, x, token_block=4096)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("name", MOE)
def test_exact_gate_ties_resolve_as_lax_top_k(name, dispatch):
    """Router columns repeated in groups of four give every token exactly
    equal gates within a group; ``jax.lax.top_k`` takes the lowest indices,
    and so does the port (the experts differ, so another pick would change
    the output)."""
    jcfg, cfg = _cfgs(name, dispatch)
    w = _weights(jcfg, seed=5)
    r = w["router_col"]
    for g in range(0, cfg.moe_experts, 4):
        r[:, g:g + 4] = r[:, g:g + 1]
    x = np.random.default_rng(5).normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    xt = torch.tensor(x.reshape(-1, cfg.d_model))
    gates = torch.softmax((xt @ torch.tensor(r)).float()[:, :cfg.moe_experts], -1)
    assert (gates[:, 0] == gates[:, 1]).all()  # the ties are exact
    _, topi, _, _ = _route(xt, torch.tensor(r), cfg.moe_experts, cfg.moe_top_k, 1 << 20)
    jtop = jax.lax.top_k(jnp.asarray(gates.numpy()), cfg.moe_top_k)[1]
    assert np.array_equal(topi.numpy(), np.asarray(jtop))
    assert (topi % 4 == torch.arange(cfg.moe_top_k)).all()  # lowest index first
    got, want = _run(jcfg, cfg, w, x, token_block=4096)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The reduced models whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE)
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


def test_params_from_jax_carries_the_expert_leaves(pair):
    """The stacked (L, E, D, F) expert leaves and the router, shared and
    residual leaves arrive unchanged."""
    _, jparams, model, params = pair
    jmoe = jparams["layers"]["moe"]
    assert set(params["layers"]["moe"]) == set(jmoe)
    for k, v in jmoe.items():
        t = params["layers"]["moe"][k]
        assert tuple(t.shape) == v.shape and np.array_equal(t.numpy(), np.asarray(v))
    assert params["layers"]["moe"]["w1_exp"].shape == (
        model.cfg.n_layers, 64 if model.cfg.moe_pad_experts else model.cfg.moe_experts,
        model.cfg.d_model, model.cfg.d_ff)


def test_prefill_and_three_decode_steps_match_the_reference(pair):
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache_len=24)
    tl, tc = model.prefill(params, {"tokens": torch.tensor(toks)}, cache_len=24)
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


@pytest.mark.parametrize("n_slots,cache_len,requests", [
    (2, 64, [([1, 2, 3], 5)] * 5),
    (3, 40, [(list(range(7, 7 + n)), 3 + n % 5) for n in (1, 30, 9, 40, 2, 17, 5)]),
], ids=["batches", "mixed"])
def test_serve_engine_tokens_equal_the_reference(pair, n_slots, cache_len, requests):
    """Empty slots are routed with the rest on every tick, as in the
    reference: the same outputs token for token, in the same order."""
    jmodel, jparams, model, params = pair

    def serve(engine_cls, m, p, **kw):
        eng = engine_cls(m, p, n_slots=n_slots, cache_len=cache_len, **kw)
        reqs = [eng.submit(pr, max_new_tokens=n) for pr, n in requests]
        done = eng.run(max_ticks=200)
        return [r.output for r in reqs], [r.rid for r in done]

    assert serve(ServeEngine, model, params, device="cpu") == serve(JServeEngine, jmodel,
                                                                    jparams)
