"""The port's SSM blocks (``repro_torch.models.ssm``) against the reference's
on the CPU.

Each function gets the same inputs, drawn from a numpy seed, in both
packages: the chunked SSD (S a multiple of the chunk, ragged, shorter than
one chunk; with and without an initial state), its decode step, and the
Mamba2, mLSTM and sLSTM layers and their decode steps, on the reduced
configs' widths. Float32 agrees within ``atol=1e-5``, except the Mamba2
and mLSTM layers, whose chunked SSD contracts three operands in an order
XLA picks for itself: they are held within ``1e-4`` (seen: 1.6e-5 on
outputs near 2, a relative 7.5e-6). bfloat16 agrees within ``2e-2`` (the
reference's XLA keeps some intermediates in float32 where the port rounds
each op). The decode steps, run token by token from zero state,
also reproduce the port's own full-sequence layers: the recurrence the card
checks at full width in ``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import ssm

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a: np.ndarray, dtype: str):
    """The same values in both packages, rounded once to ``dtype``."""
    jt, tt, _ = DTYPES[dtype]
    ja = jnp.asarray(a.astype(np.float32)).astype(jt)
    return ja, torch.tensor(np.asarray(ja.astype(jnp.float32))).to(tt)


def _close(got: torch.Tensor, want, atol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _ssd_inputs(rng, B, S, H, P, N):
    return (rng.normal(size=(B, S, H, P)) * 0.5,
            -rng.uniform(0.0, 1.5, size=(B, S, H)),
            rng.normal(size=(B, S, N)) * 0.5,
            rng.normal(size=(B, S, N)) * 0.5,
            rng.uniform(0.1, 1.0, size=(B, S, H)))


# ---------------------------------------------------------------------------
# The chunked SSD and its decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S", [64, 50, 20], ids=["whole-chunks", "ragged", "one-short-chunk"])
def test_ssd_chunked_matches_the_reference(S, with_h0, dtype):
    """y and the final state; chunk 16, so S = 64 is four whole chunks, 50
    pads its last chunk and 20 pads one. The float32 log decays, dt and the
    state are drawn in float32 in both dtypes (as the models pass them)."""
    rng = np.random.default_rng(S + 10 * with_h0)
    B, H, P, N = 2, 3, 8, 4
    x, a_log, b, c, dt = _ssd_inputs(rng, B, S, H, P, N)
    jx, tx = _pair(x, dtype)
    jb, tb = _pair(b, dtype)
    jc, tc = _pair(c, dtype)
    ja, ta = _pair(a_log, "float32")
    jd, td = _pair(dt, "float32")
    jh0 = th0 = None
    if with_h0:
        jh0, th0 = _pair(rng.normal(size=(B, H, N, P)), "float32")
    jy, jh = jssm.ssd_chunked(jx, ja, jb, jc, jd, chunk=16, h0=jh0)
    y, h = ssm.ssd_chunked(tx, ta, tb, tc, td, chunk=16, h0=th0)
    assert y.dtype == DTYPES[dtype][1] and h.dtype == torch.float32
    assert y.shape == (B, S, H, P) and h.shape == (B, H, N, P)
    atol = DTYPES[dtype][2]
    _close(y, jy, atol)
    _close(h, jh, atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step_matches_the_reference(dtype):
    rng = np.random.default_rng(7)
    B, H, P, N = 3, 4, 8, 5
    jh, th = _pair(rng.normal(size=(B, H, N, P)), "float32")
    jx, tx = _pair(rng.normal(size=(B, H, P)), dtype)
    ja, ta = _pair(-rng.uniform(0, 2, size=(B, H)), "float32")
    jb, tb = _pair(rng.normal(size=(B, N)), dtype)
    jc, tc = _pair(rng.normal(size=(B, N)), dtype)
    jd, td = _pair(rng.uniform(0.1, 1, size=(B, H)), "float32")
    jh2, jy = jssm.ssd_decode_step(jh, jx, ja, jb, jc, jd)
    h2, y = ssm.ssd_decode_step(th, tx, ta, tb, tc, td)
    assert y.dtype == DTYPES[dtype][1] and h2.dtype == torch.float32
    _close(h2, jh2, DTYPES[dtype][2])
    _close(y, jy, DTYPES[dtype][2])


def test_ssd_clips_log_decays_below_minus_60():
    """A log decay of -100 a step is clipped to -60 inside the exp, as the
    reference clips it: the intra-chunk decays stay finite."""
    rng = np.random.default_rng(9)
    x, a_log, b, c, dt = _ssd_inputs(rng, 1, 8, 2, 4, 3)
    a_log[:, 3] = -100.0
    jy, jh = jssm.ssd_chunked(*(jnp.asarray(a.astype(np.float32)) for a in (x, a_log, b, c, dt)),
                              chunk=8)
    y, h = ssm.ssd_chunked(*(torch.tensor(a.astype(np.float32)) for a in (x, a_log, b, c, dt)),
                           chunk=8)
    assert bool(torch.isfinite(y).all())
    _close(y, jy, 1e-5)
    _close(h, jh, 1e-5)


# ---------------------------------------------------------------------------
# Layers: Mamba2 (the hybrid's), mLSTM and sLSTM (the ssm family's)
# ---------------------------------------------------------------------------


def _params(shapes: dict, rng, dtype: str):
    """Both packages' parameter dicts from one draw: weights at scale
    1/sqrt(fan_in), the skip and norms near 1, ``dt_bias`` and ``a_log``
    in float32 whatever the dtype (as ``init`` makes them)."""
    jp, tp = {}, {}
    for name, shape in shapes.items():
        if name in ("dt_bias", "a_log"):
            a = rng.normal(size=shape) * 0.5
            jp[name], tp[name] = _pair(a, "float32")
            continue
        if name == "d_skip":
            a = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            a = rng.normal(size=shape) / np.sqrt(fan_in)
        jp[name], tp[name] = _pair(a, dtype)
    return jp, tp


LAYERS = {
    # name: (config, param shapes, full-sequence layer, decode step)
    "mamba2": ("zamba2-7b", "mamba2_param_shapes", "mamba2_layer", "mamba2_decode"),
    "mlstm": ("xlstm-350m", "mlstm_param_shapes", "mlstm_layer", "mlstm_decode"),
    "slstm": ("xlstm-350m", "slstm_param_shapes", "slstm_layer", "slstm_decode"),
}


def _zero_state(kind: str, cfg, B: int, dtype: torch.dtype):
    """The state a decode starts from: the models' zero state for one
    layer."""
    D, H = cfg.d_model, cfg.n_heads
    if kind == "mamba2":
        Hs, N = cfg.ssm_heads, cfg.ssm_state
        return (torch.zeros((B, Hs, N, cfg.d_inner // Hs)),
                torch.zeros((B, cfg.ssm_conv - 1, cfg.d_inner + 2 * N), dtype=dtype))
    if kind == "mlstm":
        P = D // H
        return torch.zeros((B * H, 1, P, P)), torch.zeros((B * H, 1, P, 1))
    return (torch.zeros((B, D)), torch.zeros((B, D)), torch.full((B, D), -30.0),
            torch.zeros((B, H, D // H), dtype=dtype))


def _jstate(state):
    return tuple(jnp.asarray(s.float().numpy()).astype(
        jnp.bfloat16 if s.dtype == torch.bfloat16 else jnp.float32) for s in state)


def test_param_shapes_equal_the_reference():
    """At the reduced and at the published widths."""
    for kind, (arch, shapes, _, _) in LAYERS.items():
        for port_cfg, ref_cfg in ((reduced_config, jreduced_config), (get_config, jget_config)):
            assert getattr(ssm, shapes)(port_cfg(arch)) == getattr(jssm, shapes)(ref_cfg(arch)), kind


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 45], ids=["one-chunk", "ragged"])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_matches_the_reference(kind, S, dtype):
    """The full-sequence layer on the reduced config (chunk 32: S = 45 pads
    its second chunk)."""
    arch, shapes, layer, _ = LAYERS[kind]
    cfg, jcfg = reduced_config(arch, dtype=dtype), jreduced_config(arch, dtype=dtype)
    rng = np.random.default_rng(S)
    jp, tp = _params(getattr(ssm, shapes)(cfg), rng, dtype)
    jx, tx = _pair(rng.normal(size=(2, S, cfg.d_model)), dtype)
    got = getattr(ssm, layer)(tp, tx, cfg)
    want = getattr(jssm, layer)(jp, jx, jcfg)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, S, cfg.d_model)
    # the chunked SSD's three-operand contractions: see the module's note
    atol = 1e-4 if dtype == "float32" and kind != "slstm" else DTYPES[dtype][2]
    _close(got, want, atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_decode_steps_match_the_reference(kind, dtype):
    """Four decode steps from a random state, each step's output and state
    against the reference's, the port's state carried to its next step."""
    arch, shapes, _, decode = LAYERS[kind]
    cfg, jcfg = reduced_config(arch, dtype=dtype), jreduced_config(arch, dtype=dtype)
    rng = np.random.default_rng(17)
    jp, tp = _params(getattr(ssm, shapes)(cfg), rng, dtype)
    B = 3
    state = tuple(torch.tensor(rng.normal(size=s.shape).astype(np.float32)).to(s.dtype)
                  if kind != "slstm" or i != 2 else s
                  for i, s in enumerate(_zero_state(kind, cfg, B, DTYPES[dtype][1])))
    if kind == "slstm":  # normalisers are positive
        state = (state[0], state[1].abs(), state[2], state[3])
    jstate = _jstate(state)
    atol = DTYPES[dtype][2]
    for _ in range(4):
        jx, tx = _pair(rng.normal(size=(B, cfg.d_model)), dtype)
        want, jstate = getattr(jssm, decode)(jp, jx, jstate, jcfg)
        got, state = getattr(ssm, decode)(tp, tx, state, cfg)
        assert got.dtype == DTYPES[dtype][1] and got.shape == (B, cfg.d_model)
        _close(got, want, atol)
        for s, js in zip(state, jstate):
            assert s.shape == js.shape
            _close(s, js, atol)


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_decode_from_zero_state_reproduces_the_layer(kind):
    """Float32: the decode step run token by token from zero state gives
    the full-sequence layer's outputs (the chunked SSD, the mLSTM
    normaliser and the causal conv against the conv buffer compute one
    function), within 1e-5."""
    arch, shapes, layer, decode = LAYERS[kind]
    cfg = reduced_config(arch)
    rng = np.random.default_rng(23)
    _, tp = _params(getattr(ssm, shapes)(cfg), rng, "float32")
    x = torch.tensor(rng.normal(size=(2, 45, cfg.d_model)).astype(np.float32))
    full = getattr(ssm, layer)(tp, x, cfg)
    state = _zero_state(kind, cfg, 2, torch.float32)
    for t in range(45):
        y, state = getattr(ssm, decode)(tp, x[:, t], state, cfg)
        _close(y, full[:, t].numpy(), 1e-5)


def test_causal_conv_matches_the_reference():
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.normal(size=(2, 9, 6)), "float32")
    jw, tw = _pair(rng.normal(size=(4, 6)), "float32")
    _close(ssm._causal_conv(tx, tw), jssm._causal_conv(jx, jw), 1e-6)
