"""The port's attention against the reference on the CPU.

The plain versions (``repro_torch.kernels.ref``) are held against the
reference's Pallas kernels in interpret mode and against its jnp oracles, at
the shapes, GQA groups and causal cases of the reference's kernel sweeps
(``tests/test_kernels.py``), with its tolerances: ``atol=2e-5`` in float32;
in bfloat16 ``2e-2`` for flash attention and for the oracles, ``3e-2`` for
the decode kernel (it rounds q·scale to bfloat16 before the dot, the oracles
do not). Inputs are drawn with numpy from a seed and handed to both
packages; bfloat16 inputs are rounded from the same float32 values.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(JAX_DT[dtype]), torch.tensor(x).to(TORCH_DT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


@pytest.mark.parametrize("shape", [(2, 128, 4, 64), (1, 256, 8, 32), (3, 64, 6, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ref_vs_reference_kernel(shape, dtype, causal):
    """atol 2e-5 (float32) / 2e-2 (bfloat16), against the Pallas kernel in
    interpret mode and against the jnp oracle."""
    rng = np.random.default_rng(sum(shape))
    (jq, q), (jk, k), (jv, v) = (_pair(rng, shape, dtype) for _ in range(3))
    got = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == TORCH_DT[dtype] and got.shape == q.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    _close(got, jops.flash_attention_op(jq, jk, jv, causal=causal, interpret=True), tol)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("kv_heads", [1, 2, 4])
def test_flash_attention_ref_gqa_vs_reference_kernel(kv_heads):
    """GQA groups 4, 2, 1 in float32: atol 2e-5."""
    B, S, H, D = 2, 128, 4, 64
    rng = np.random.default_rng(kv_heads)
    jq, q = _pair(rng, (B, S, H, D), "float32")
    jk, k = _pair(rng, (B, S, kv_heads, D), "float32")
    jv, v = _pair(rng, (B, S, kv_heads, D), "float32")
    got = ref.flash_attention_ref(q, k, v, causal=True)
    _close(got, jops.flash_attention_op(jq, jk, jv, causal=True, interpret=True), 2e-5)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=True), 2e-5)


def test_flash_attention_ref_causal_offset_vs_reference():
    """Sq < Skv: the causal mask is offset by Skv - Sq. float32, atol 2e-5."""
    rng = np.random.default_rng(7)
    jq, q = _pair(rng, (2, 64, 4, 32), "float32")
    jk, k = _pair(rng, (2, 256, 2, 32), "float32")
    jv, v = _pair(rng, (2, 256, 2, 32), "float32")
    got = ref.flash_attention_ref(q, k, v, causal=True)
    _close(got, jops.flash_attention_op(jq, jk, jv, causal=True, interpret=True), 2e-5)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=True), 2e-5)


@pytest.mark.parametrize("shape", [(2, 128, 4, 64), (4, 512, 2, 64), (1, 64, 8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ref_vs_reference_kernel(shape, dtype):
    """atol 2e-5 (float32); in bfloat16 3e-2 against the Pallas kernel in
    interpret mode and 2e-2 against the jnp oracle."""
    B, S, KH, D = shape
    H = KH * 2
    rng = np.random.default_rng(S + B)
    jq, q = _pair(rng, (B, H, D), dtype)
    jk, k = _pair(rng, (B, S, KH, D), dtype)
    jv, v = _pair(rng, (B, S, KH, D), dtype)
    lengths = rng.integers(1, S, size=B).astype(np.int32)
    got = ref.decode_attention_ref(q, k, v, torch.tensor(lengths))
    assert got.dtype == TORCH_DT[dtype] and got.shape == q.shape
    jl = jnp.asarray(lengths)
    bf16 = dtype == "bfloat16"
    _close(got, jops.decode_attention_op(jq, jk, jv, jl, interpret=True),
           3e-2 if bf16 else 2e-5)
    _close(got, jref.decode_attention_ref(jq, jk, jv, jl), 2e-2 if bf16 else 2e-5)


@pytest.mark.parametrize("op", ["flash", "decode"])
def test_attention_ops_route_cpu_to_plain_and_refuse_other_devices(op):
    """A CPU tensor takes the plain version (no kernel is built or counted);
    a tensor on any other device raises rather than falling back."""
    from repro_torch.kernels import _build

    rng = np.random.default_rng(0)
    q4 = torch.tensor(rng.normal(size=(1, 8, 4, 16)), dtype=torch.float32)
    kv4 = torch.tensor(rng.normal(size=(1, 8, 2, 16)), dtype=torch.float32)
    before = dict(_build.LAUNCHES)
    if op == "flash":
        run = lambda q, k: ops.flash_attention_op(q, k, k)  # noqa: E731
        args = (q4, kv4)
        want = ref.flash_attention_ref(q4, kv4, kv4)
    else:
        lengths = torch.tensor([5], dtype=torch.int32)
        run = lambda q, k: ops.decode_attention_op(q, k, k, lengths)  # noqa: E731
        args = (q4[:, 0], kv4)
        want = ref.decode_attention_ref(q4[:, 0], kv4, kv4, lengths)
    assert torch.equal(run(*args), want)
    assert _build.LAUNCHES == before and _build._lib is None
    with pytest.raises(ValueError, match="device"):
        run(*(a.to("meta") for a in args))


def test_attention_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.attention import decode_attention, flash_attention

    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q[:, :, :2], q[:, :, :2], causal=True, scale=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q[:, 0], q[:, :, :2], q[:, :, :2],
                         torch.ones(1, dtype=torch.int32), scale=0.25)


# ---------------------------------------------------------------------------
# The model's attention functions against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,Skv,KH,causal", [
    (96, 96, 2, True), (96, 96, 2, False), (40, 40, 4, True), (40, 40, 4, False),
    (24, 200, 1, False),
])
def test_attention_chunked_vs_reference(Sq, Skv, KH, causal):
    """float32, atol 2e-5. The reference's ``attention_chunked`` rounds
    q·scale to k's type and the softmax weights to v's type; the port's
    calls the flash-attention kernel, which keeps both in float32, as the
    reference's Pallas kernel and oracle do. In float32 the two forms
    coincide, so these float32 tests are what hold the model to the
    reference; in bfloat16 the kernels are held to their plain versions on
    the card. Sq < Skv runs non-causal only: the reference places q[0] at
    ``q_offset`` (0 here), the kernel at Skv - Sq."""
    rng = np.random.default_rng(Sq + Skv)
    jq, q = _pair(rng, (2, Sq, 4, 32), "float32")
    jk, k = _pair(rng, (2, Skv, KH, 32), "float32")
    jv, v = _pair(rng, (2, Skv, KH, 32), "float32")
    got = layers.attention_chunked(q, k, v, causal=causal)
    want = jlayers.attention_chunked(jq, jk, jv, causal=causal, q_chunk=32, k_chunk=64)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("S,KH,G", [(64, 2, 2), (300, 1, 4), (128, 4, 1)])
def test_attention_decode_vs_reference(S, KH, G):
    """float32, atol 2e-5 (see the docstring above: the forms coincide in
    float32)."""
    B, D = 3, 32
    rng = np.random.default_rng(S)
    jq, q = _pair(rng, (B, KH * G, D), "float32")
    jk, k = _pair(rng, (B, S, KH, D), "float32")
    jv, v = _pair(rng, (B, S, KH, D), "float32")
    lengths = np.array([1, S, S // 2 + 1], np.int32)
    got = layers.attention_decode(q, k, v, torch.tensor(lengths))
    _close(got, jlayers.attention_decode(jq, jk, jv, jnp.asarray(lengths)), 2e-5)


def test_attention_window_and_offset_raise():
    """Decode attention takes no window (no config reaches one); a windowed
    or causal prefill needs the kernel's offset, and a negative window is
    refused (the windowed prefill itself: tests/test_torch_recurrent.py)."""
    q = torch.zeros((1, 4, 2, 16))
    with pytest.raises(NotImplementedError, match="no config reaches it"):
        layers.attention_decode(q[:, 0], q, q, torch.ones(1, dtype=torch.int32), window=8)
    with pytest.raises(NotImplementedError, match="offset"):
        layers.attention_chunked(q, q, q, causal=True, q_offset=2)
    with pytest.raises(NotImplementedError, match="offset"):
        layers.attention_chunked(q, q, q, causal=False, window=8, q_offset=2)
    with pytest.raises(ValueError, match="window"):
        layers.attention_chunked(q, q, q, window=-1)
