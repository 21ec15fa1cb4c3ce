"""The algorithms of the port's redesigned attention kernels, on the CPU,
against the reference package.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
What they compute differently from their plain versions is emulated here in
plain PyTorch, step for step, and held against the reference's Pallas
kernels (interpret mode) and jnp oracles:

* split-KV decode: the cache cut by ``decode_splits`` into chunks, each
  streamed with an online softmax in exp2 (float32: 32-row tiles;
  bfloat16: four warp streams of 16 keys, P rounded to bfloat16 for
  P·V, merged in warp order) and written as unnormalised partials
  (m, l, acc), an empty chunk as (-inf, 0); then the partials folded in
  split order. Tolerances: float32 ``2e-5``; bfloat16 ``3e-2`` against the
  Pallas kernel (it rounds q·scale to bfloat16, the kernels do not) and
  ``2e-2`` against the oracle.
* tensor-core flash attention: tiles of 64 keys, an online softmax in f32,
  and P rounded to bfloat16 before P·V (the one rounding the tensor-core
  kernel adds), against the oracle in bfloat16 at ``2e-2``.

Inputs are drawn with numpy from a seed and handed to both packages.
"""
from __future__ import annotations

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels.attention import (
    SPLIT_BLOCKS,
    SPLIT_MIN_ROWS,
    SPLIT_TILE,
    decode_splits,
)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
LOG2E = 1.4426950408889634
F32_TILE = 32  # rows of a tile of the float32 (CUDA-core) decode kernel


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(JAX_DT[dtype]), torch.tensor(x).to(TORCH_DT[dtype])


def _close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# Emulations of the kernels' algorithms
# ---------------------------------------------------------------------------


def _online(qs, k, v, keys, m, l, acc, p_bf16):
    """One online-softmax step of the scaled (log2) queries ``qs`` (G, D)
    over ``keys``; P rounded to bfloat16 for P·V where the kernel does."""
    x = qs @ k[keys].T  # (G, rows)
    m_new = torch.maximum(m, x.amax(dim=1))
    alpha = torch.exp2(m - m_new)
    p = torch.exp2(x - m_new[:, None])
    pv = p.to(torch.bfloat16).float() if p_bf16 else p
    return m_new, l * alpha + p.sum(dim=1), acc * alpha[:, None] + pv @ v[keys]


def _merge(parts, G, D):
    """Partials (m, l, acc), acc None where nothing was seen, folded in
    order: rescaled to the largest m and summed."""
    m_all = torch.stack([p[0] for p in parts]).amax(dim=0)
    l_tot, o = torch.zeros(G), torch.zeros((G, D))
    for m_s, l_s, acc_s in parts:
        if acc_s is None:
            continue
        w = torch.exp2(m_s - m_all)
        l_tot = l_tot + l_s * w
        o = o + acc_s * w[:, None]
    return m_all, l_tot, o


def split_decode_emulation(q, k_cache, v_cache, lengths, scale=None):
    """What ``csrc/decode_attention.cu`` computes, in float32 sums. Pass 1
    over every (batch, KV head, split): in float32 one online softmax over
    the chunk in ``F32_TILE``-row tiles (the CUDA-core kernel); in
    bfloat16 four warp streams, warp w taking keys 64 j + 16 w .. + 16 of
    each 64-key tile, P rounded to bfloat16 for P·V, merged in warp order
    (the tensor-core kernel). Pass 2 folds the splits in split order."""
    B, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    bf16 = q.dtype == torch.bfloat16
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    n_split, chunk = decode_splits(S, B, KH)
    qs = q.float().reshape(B, KH, G, D) * (scale * LOG2E)
    kf, vf = k_cache.float(), v_cache.float()
    out = torch.empty((B, KH, G, D))
    empty = (torch.full((G,), -math.inf), torch.zeros(G), None)
    for b in range(B):
        n = int(lengths[b])
        for h in range(KH):
            k, v = kf[b, :, h], vf[b, :, h]
            parts = []
            for s in range(n_split):
                start, end = s * chunk, min(n, (s + 1) * chunk)
                if start >= n:
                    parts.append(empty)
                    continue
                streams = ([range(t, min(end, t + 16)) for t in range(start + 16 * w, end, 64)]
                           for w in range(4)) if bf16 else (
                    [range(t, min(end, t + F32_TILE)) for t in range(start, end, F32_TILE)],)
                warps = []
                for groups in streams:
                    if not groups:
                        warps.append(empty)
                        continue
                    state = (torch.full((G,), -math.inf), torch.zeros(G), torch.zeros((G, D)))
                    for keys in groups:
                        state = _online(qs[b, h], k, v, list(keys), *state, p_bf16=bf16)
                    warps.append(state)
                parts.append(_merge(warps, G, D))
            _, l_tot, o = _merge(parts, G, D)
            out[b, h] = o / l_tot[:, None]
    return out.reshape(B, H, D).to(q.dtype)


def flash_bf16_emulation(q, k, v, causal=True, scale=None, block_k=64):
    """What ``csrc/flash_attention_wgmma.cu`` computes for bfloat16: f32
    scores and softmax over tiles of ``block_k`` keys, P rounded to bfloat16
    before P·V, the normaliser summed from the unrounded P."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, Sq, KH, G, D)
    kf, vf = k.float(), v.float()
    m = torch.full((B, KH, G, Sq), -math.inf)
    l = torch.zeros((B, KH, G, Sq))
    o = torch.zeros((B, KH, G, Sq, D))
    rows = torch.arange(Sq)[:, None] + (Skv - Sq)
    for t0 in range(0, Skv, block_k):
        t1 = min(Skv, t0 + block_k)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf[:, t0:t1]) * (scale * LOG2E)
        if causal:
            keep = rows >= torch.arange(t0, t1)[None, :]
            s = torch.where(keep, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        mu = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.where(m_new == -math.inf, 1.0, torch.exp2(m - m_new))
        p = torch.exp2(s - mu[..., None])
        l = l * alpha + p.sum(dim=-1)
        pb = p.to(torch.bfloat16).float()
        o = o * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", pb, vf[:, t0:t1])
        m = m_new
    out = o / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# (a) split-KV decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,KH,G,D,lengths", [
    # B * KH = 1: every split of a single sequence, the length at a chunk's
    # edges and past it
    (1, 1024, 1, 4, 64, "edges"),
    # lengths that leave whole chunks empty (chunks of 128 rows here)
    (3, 256, 2, 4, 32, [1, 65, 130]),
    (2, 512, 4, 2, 128, [511, 3]),
    (4, 300, 1, 8, 16, "random"),
])
def test_split_decode_emulation_vs_reference(dtype, B, S, KH, G, D, lengths):
    rng = np.random.default_rng(S + B + G)
    H = KH * G
    jq, q = _pair(rng, (B, H, D), dtype)
    jk, k = _pair(rng, (B, S, KH, D), dtype)
    jv, v = _pair(rng, (B, S, KH, D), dtype)
    n_split, chunk = decode_splits(S, B, KH)
    if lengths == "edges":
        cases = [[1], [chunk - 1], [chunk], [chunk + 1], [S]]
    elif lengths == "random":
        cases = [rng.integers(1, S + 1, size=B).tolist()]
    else:
        cases = [lengths]
    assert n_split > 1
    bf16 = dtype == "bfloat16"
    for lens in cases:
        lens = np.asarray(lens * (B // len(lens)), np.int32)
        got = split_decode_emulation(q, k, v, torch.tensor(lens))
        assert got.dtype == TORCH_DT[dtype] and got.shape == q.shape
        jl = jnp.asarray(lens)
        _close(got, jops.decode_attention_op(jq, jk, jv, jl, interpret=True),
               3e-2 if bf16 else 2e-5)
        _close(got, jref.decode_attention_ref(jq, jk, jv, jl), 2e-2 if bf16 else 2e-5)


def test_split_decode_emulation_ignores_rows_past_the_lengths():
    """Rows past each length hold NaN; no split reads them."""
    rng = np.random.default_rng(5)
    _, q = _pair(rng, (2, 4, 32), "float32")
    jk, k = _pair(rng, (2, 256, 1, 32), "float32")
    jv, v = _pair(rng, (2, 256, 1, 32), "float32")
    lens = np.array([70, 129], np.int32)
    kn, vn = k.clone(), v.clone()
    for b, n in enumerate(lens):
        kn[b, n:] = float("nan")
        vn[b, n:] = float("nan")
    got = split_decode_emulation(q, kn, vn, torch.tensor(lens))
    jq = jnp.asarray(q.numpy())
    _close(got, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)), 2e-5)


# ---------------------------------------------------------------------------
# (b) flash attention with P rounded to bfloat16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,causal", [
    (2, 128, 128, 8, 2, 64, True),  # GQA 4, whole tiles
    (1, 100, 100, 4, 4, 32, True),  # ragged, Sq == Skv
    (2, 37, 203, 4, 1, 24, True),  # causal offset Skv - Sq, D padded to 32
    (1, 129, 203, 2, 2, 8, True),  # D padded to 16
    (2, 1, 203, 4, 2, 16, True),  # one query row
    (1, 77, 150, 8, 1, 128, False),
])
def test_flash_bf16_emulation_vs_reference(B, Sq, Skv, H, KH, D, causal):
    rng = np.random.default_rng(Sq * 1000 + Skv + D)
    jq, q = _pair(rng, (B, Sq, H, D), "bfloat16")
    jk, k = _pair(rng, (B, Skv, KH, D), "bfloat16")
    jv, v = _pair(rng, (B, Skv, KH, D), "bfloat16")
    got = flash_bf16_emulation(q, k, v, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal), 2e-2)


# ---------------------------------------------------------------------------
# (c) the split planner
# ---------------------------------------------------------------------------


def test_decode_splits_takes_shapes_only():
    """The planner's inputs are S, B and KH: nothing it could learn from the
    lengths, which the host would have to read back from the card."""
    assert list(inspect.signature(decode_splits).parameters) == ["S", "B", "KH"]
    assert decode_splits(1024, 16, 8) == (4, 256)  # the serving path's decode


@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 100, 203, 512, 1000, 1024, 4096, 32768])
@pytest.mark.parametrize("B,KH", [(1, 1), (3, 1), (16, 8), (64, 8), (200, 16)])
def test_decode_splits_cover_the_cache(S, B, KH):
    n_split, chunk = decode_splits(S, B, KH)
    assert n_split >= 1 and chunk % SPLIT_TILE == 0
    starts = [i * chunk for i in range(n_split)]
    assert starts[-1] < S <= n_split * chunk  # [0, S) exactly, no split empty of rows
    assert chunk >= min(SPLIT_MIN_ROWS, S)
    assert n_split == 1 or B * KH * n_split <= SPLIT_BLOCKS
    assert decode_splits(S, B, KH) == (n_split, chunk)


def test_decode_splits_refuses_empty_shapes():
    for args in ((0, 1, 1), (16, 0, 1), (16, 1, 0)):
        with pytest.raises(ValueError):
            decode_splits(*args)
