"""The vlm family (llava-next-34b) against the reference on the CPU.

Reduced llava (2 layers, d_model 64, H 4 over KH 2, 16 patch rows) in both
packages on the reference's weights (``tests/torch_zoo_pair.py``), driven
through the Model API as the reference's tests drive it: ``prefill`` with
``patches`` and tokens, then ``decode`` steps. Float32 logits and caches
agree within 1e-5, bfloat16 within 2e-2 (the zoo's tolerances: XLA keeps
some bf16 intermediates in float32).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import ServeEngine as JServeEngine
from repro_torch.models import layers, zoo
from repro_torch.serve import ServeEngine
from torch_zoo_pair import close, pair_of_models, run_both

VLM = "llava-next-34b"


@pytest.fixture(scope="module")
def pair():
    return pair_of_models(VLM)


def _batch(cfg, B: int, S: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32),
        "patches": (rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)) * 0.5
                    ).astype(np.float32),
    }


@pytest.mark.parametrize("S", [1, 12, 40])
def test_prefill_and_three_decode_steps_match_the_reference(pair, S):
    """The prompt after the 16 patch rows; the caches of 16 + S + 4 rows;
    three decode steps at ragged lengths (each sequence's own patch rows,
    prompt and steps so far)."""
    cfg = pair[2].cfg
    P = cfg.frontend_tokens
    batch = _batch(cfg, 3, S, seed=S)
    lengths = np.array([P + S, P + S - 1, P], np.int32) if S > 1 else np.full(3, P + 1)
    tl, tc = run_both(pair, batch, cache_len=P + S + 4, lengths=lengths, steps=3,
                      atol=1e-5)
    assert tuple(tc[0].shape) == (cfg.n_layers, 3, P + S + 4, cfg.n_kv_heads, cfg.hd)
    assert float(tl[:, cfg.vocab_size:].max()) == np.float32(-1e30)  # padded vocab masked


def test_bf16_prefill_and_decode_match_the_reference():
    """bfloat16, the float32 patches cast to the model's dtype in both."""
    pair = pair_of_models(VLM, dtype="bfloat16", seed=3)
    cfg = pair[2].cfg
    P = cfg.frontend_tokens
    batch = _batch(cfg, 2, 20, seed=7)
    tl, tc = run_both(pair, batch, cache_len=P + 24, lengths=np.array([P + 20, P + 9]),
                      steps=3, atol=2e-2)
    assert tl.dtype == torch.bfloat16 and all(c.dtype == torch.bfloat16 for c in tc)


def test_text_positions_start_after_the_patch_rows(pair):
    """The quirk kept from the reference: RoPE positions run over the patch
    rows, so layer 0's K row of text token j (its input is the token's
    embedding alone) is rotated to position P + j; the patches' K rows
    come from the projected patches at positions 0..P-1."""
    _, _, model, params = pair
    cfg = model.cfg
    P = cfg.frontend_tokens
    batch = {k: torch.tensor(v) for k, v in _batch(cfg, 2, 6, seed=1).items()}
    _, (kc, _) = model.prefill(params, batch)
    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    ln1 = params["layers"]["ln1"][0]

    def k_rows(h, positions):
        k = layers.attn_proj_qkv(lp, layers.rmsnorm(h, ln1, cfg.norm_eps), cfg)[1]
        return layers.rope(k, positions, cfg.rope_theta)

    text = k_rows(params["embed"][batch["tokens"]], torch.arange(P, P + 6)[None])
    patches = k_rows(batch["patches"] @ params["vision_proj_col"], torch.arange(P)[None])
    close(kc[0, :, P:P + 6], text.numpy(), 1e-6)
    close(kc[0, :, :P], patches.numpy(), 1e-6)


def test_tp_head_padding_is_exact(pair):
    """The reference's ``test_tp_head_padding_is_exact`` in the port:
    repeat-KV and zero-padded heads (``tp_pad_heads`` 8) give the prefill's
    logits bit for bit those of 0, and the caches keep the original KV
    heads."""
    _, _, model, params = pair
    padded = zoo.build_model(dataclasses.replace(model.cfg, tp_pad_heads=8))
    cfg = model.cfg
    B, S = 2, 32
    batch = {
        "tokens": torch.arange(B * S, dtype=torch.int32).reshape(B, S) % cfg.vocab_size,
        "patches": torch.ones((B, cfg.frontend_tokens, cfg.d_model)) * 0.01,
    }
    g0, c0 = model.prefill(params, batch)
    g1, c1 = padded.prefill(params, batch)
    assert torch.equal(g0, g1)
    assert [c.shape for c in c0] == [c.shape for c in c1]
    assert c0[0].shape[3] == cfg.n_kv_heads


def test_prefill_without_patches_raises_in_both_packages(pair):
    jmodel, jparams, model, params = pair
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(KeyError, match="patches"):
        jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    with pytest.raises(KeyError, match=r"patches.*\(B, 16, 64\)"):
        model.prefill(params, {"tokens": torch.tensor(toks)})


def test_full_cache_raises_before_the_write(pair):
    """A decode step at a length equal to the cache's rows: the reference
    drops the write silently (JAX's out-of-bounds scatter); the port raises
    ValueError before it writes anything."""
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    batch = _batch(cfg, 2, 4, seed=2)
    full = cfg.frontend_tokens + 4
    jl, jc = jmodel.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    step = {"tokens": np.zeros(2, np.int32), "lengths": np.array([full, 3], np.int32)}
    _, jc2 = jmodel.decode(jparams, {k: jnp.asarray(v) for k, v in step.items()}, jc)
    assert np.array_equal(np.asarray(jc2[0])[:, 0], np.asarray(jc[0])[:, 0])  # row dropped
    _, tc = model.prefill(params, {k: torch.tensor(v) for k, v in batch.items()})
    before = [c.clone() for c in tc]
    with pytest.raises(ValueError, match=f"cache of {full} rows"):
        model.decode(params, {k: torch.tensor(v) for k, v in step.items()}, tc)
    assert all(torch.equal(a, b) for a, b in zip(tc, before))


def test_shapes_and_init_match_the_reference_layout():
    """``vision_proj_col`` (d_model, d_model) beside the dense LM's leaves;
    the port's init draws the same leaves, shapes and dtypes, the
    projector at the reference's scale."""
    jmodel, jparams, model, _ = pair_of_models(VLM, dtype="bfloat16")
    assert model.shapes == jmodel.shapes
    assert model.shapes["vision_proj_col"] == (64, 64)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    jflat = {"/".join(str(k.key) for k in path): v
             for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert model.leaves.keys() == jflat.keys()
    for path, t in model.leaves.items():
        assert tuple(t.shape) == jflat[path].shape and t.dtype == torch.bfloat16, path
    assert abs(float(params["vision_proj_col"].float().std()) - 0.02) < 5e-3


def test_params_from_jax_keeps_the_projector_bits():
    _, jparams, _, params = pair_of_models(VLM, dtype="bfloat16", seed=4)
    got = params["vision_proj_col"]
    want = np.asarray(jparams["vision_proj_col"])
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_both_serve_engines_fail_on_the_vlm(pair):
    """The reference's engine admits the vlm and fails at its first
    prefill, which passes tokens only; the port's refuses it at
    construction, saying that the prefill takes ``patches``."""
    jmodel, jparams, model, params = pair
    eng = JServeEngine(jmodel, jparams, n_slots=2, cache_len=64)
    eng.submit(list(range(8)), max_new_tokens=2)
    with pytest.raises(KeyError, match="patches"):
        eng.run()
    with pytest.raises(NotImplementedError, match=r"refused: its prefill takes .*patches"):
        ServeEngine(model, params, device="cpu")
