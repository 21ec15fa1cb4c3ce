"""The port's plain kernel versions vs the reference package's kernel ops.

The same numpy inputs (made from a seed) go through ``repro_torch.kernels.ops``
on CPU tensors, which routes them to the plain PyTorch versions, and through
``repro.kernels`` in JAX on the CPU: the jnp oracles on every shape of the
reference's own sweeps (``tests/test_kernels.py``,
``tests/test_relational_kernels.py``), and the Pallas kernels in interpret
mode on a ragged subset of them. ``featurize``, ``gather_join`` and
``segment_agg`` must agree bitwise (dyadic data for ``segment_agg``, whose
sums are then exact in any order); ``tree_gemm`` within ``atol=1e-5``,
because its sum over trees runs in another order.

The CUDA kernels themselves are held against the same plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.tensor.tree2tensor import build_gemm_program, gemm_predict
from repro_torch.kernels import ops as tops


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_bitwise(got, want, what: str) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    if got.dtype == bool or want.dtype == bool:
        assert np.array_equal(got, want), f"{what}: boolean mismatch"
    else:
        assert np.array_equal(_bits(got), _bits(want)), f"{what}: bit mismatch"


def _dyadic(rng, shape, lo=-40, hi=40):
    return (rng.integers(lo, hi, size=shape) * 0.25).astype(np.float32)


# ---------------------------------------------------------------------------
# featurize
# ---------------------------------------------------------------------------

FEATURIZE_SEGS = [
    (5, (4, 4, 4)),
    (1, (2,)),
    (9, (3, 7, 2, 5)),
    (4, ()),   # numeric-only: no one-hot segments
    (0, (3, 5)),  # categorical-only: no scaler columns
]


def _featurize_inputs(n_num, segs, N, seed=3):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(N, n_num)).astype(np.float32)
    # -1 is the pad code of padded serving rows: it never matches
    cat = (
        np.stack([rng.integers(-1, s, N) for s in segs], 1)
        if segs else np.zeros((N, 0))
    ).astype(np.int32)
    offset = rng.normal(size=n_num).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=n_num).astype(np.float32)
    starts = np.cumsum([0] + list(segs))[:-1]
    cat_values = np.concatenate(
        [np.arange(s) for s in segs] or [np.zeros(0)]
    ).astype(np.int32)
    cat_segments = tuple((int(s), int(l)) for s, l in zip(starts, segs))
    return num, cat, offset, scale, cat_values, cat_segments


def _port_featurize(num, cat, offset, scale, cat_values, cat_segments):
    t = torch.from_numpy
    return tops.featurize_op(
        t(num), t(cat), t(offset), t(scale), t(cat_values), cat_segments
    )


@pytest.mark.parametrize("N", [0, 100, 256, 257])
@pytest.mark.parametrize("n_num,segs", FEATURIZE_SEGS)
def test_featurize_plain_bitwise_vs_jnp_oracle(n_num, segs, N):
    num, cat, offset, scale, cat_values, cat_segments = _featurize_inputs(
        n_num, segs, N
    )
    got = _port_featurize(num, cat, offset, scale, cat_values, cat_segments)
    want = jref.featurize_ref(
        jnp.asarray(num), jnp.asarray(cat), jnp.asarray(offset),
        jnp.asarray(scale), jnp.asarray(cat_values), cat_segments,
    )
    assert got.shape == (N, n_num + sum(segs))
    _assert_bitwise(got, want, "featurize")


@pytest.mark.parametrize("n_num,segs", FEATURIZE_SEGS)
def test_featurize_plain_bitwise_vs_pallas_interpret(n_num, segs):
    """257 rows: not a multiple of the Pallas kernel's row block."""
    args = _featurize_inputs(n_num, segs, 257)
    got = _port_featurize(*args)
    num, cat, offset, scale, cat_values, cat_segments = args
    want = jops.featurize_op(
        jnp.asarray(num), jnp.asarray(cat), jnp.asarray(offset),
        jnp.asarray(scale), jnp.asarray(cat_values), cat_segments,
        interpret=True,
    )
    _assert_bitwise(got, want, "featurize")


# ---------------------------------------------------------------------------
# tree_gemm
# ---------------------------------------------------------------------------


def _numeric_matrix(hospital):
    joined = hospital.joined_columns()
    return np.stack([joined[c] for c in hospital.numeric], 1).astype(np.float32)


def _port_tree_gemm(X, A, B, C, D, V, base):
    t = torch.from_numpy
    return tops.tree_gemm_op(t(X), t(A), t(B), t(C), t(D), t(V), base=base)


@pytest.mark.parametrize("n_estimators,max_depth", [(1, 3), (8, 4), (20, 2)])
def test_tree_gemm_plain_vs_pallas_interpret(hospital, n_estimators, max_depth):
    from repro.ml import GradientBoostingClassifier

    X = _numeric_matrix(hospital)
    gb = GradientBoostingClassifier(
        n_estimators=n_estimators, max_depth=max_depth
    ).fit(X, hospital.label)
    prog = build_gemm_program(gb.ensemble)
    A, B, C, D, V = jops.pad_gemm_program(
        prog.A, prog.B, prog.C, prog.Dcount, prog.V
    )
    Xs = X[:512]
    got = _port_tree_gemm(Xs, A, B, C, D, V, prog.base)
    want = jops.tree_gemm_op(
        jnp.asarray(Xs), jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
        jnp.asarray(D), jnp.asarray(V), base=prog.base, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(gemm_predict(prog, jnp.asarray(Xs))), atol=1e-5
    )


def test_tree_gemm_padding_is_inert(hospital):
    """Padding F/I/L of the program (the port pads once, at compile time,
    and the CUDA kernel reads x as zero past its width) changes no score,
    and the port's padding is the reference's, array for array."""
    from repro.ml import DecisionTreeClassifier

    X = _numeric_matrix(hospital)[:128]
    dt = DecisionTreeClassifier(max_depth=5).fit(
        _numeric_matrix(hospital), hospital.label
    )
    prog = build_gemm_program(dt.ensemble)
    want = np.asarray(gemm_predict(prog, jnp.asarray(X)))
    for align in (8, 64, 128, 256):
        padded = tops.pad_gemm_program(
            prog.A, prog.B, prog.C, prog.Dcount, prog.V, align=align
        )
        for mine, theirs in zip(padded, jops.pad_gemm_program(
            prog.A, prog.B, prog.C, prog.Dcount, prog.V, align=align
        )):
            assert np.array_equal(mine, theirs)
        got = _port_tree_gemm(X, *padded, prog.base)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---------------------------------------------------------------------------
# gather_join
# ---------------------------------------------------------------------------


def _join_inputs(N, M):
    rng = np.random.default_rng(N * 1000 + M)
    keys = np.sort(rng.choice(3 * M, size=M, replace=False)).astype(np.int32)
    fk = rng.integers(0, 3 * M, size=N).astype(np.int32)  # ~2/3 miss
    spay = _dyadic(rng, (M, 3))
    return fk, keys, spay


def _port_join(fk, keys, spay):
    t = torch.from_numpy
    return tops.gather_join_op(t(fk), t(keys), t(spay))


@pytest.mark.parametrize("N", [0, 1, 100, 256, 257])
@pytest.mark.parametrize("M", [1, 7, 128, 130])
def test_gather_join_plain_bitwise_vs_jnp_oracle(N, M):
    fk, keys, spay = _join_inputs(N, M)
    out, hit = _port_join(fk, keys, spay)
    want_out, want_hit = jref.gather_join_ref(
        jnp.asarray(fk), jnp.asarray(keys), jnp.asarray(spay)
    )
    _assert_bitwise(out, want_out, "payload")
    _assert_bitwise(hit, np.asarray(want_hit), "hit mask")
    assert np.array_equal(hit.numpy(), np.isin(fk, keys))


@pytest.mark.parametrize("N,M", [(0, 7), (257, 130), (100, 1)])
def test_gather_join_plain_bitwise_vs_pallas_interpret(N, M):
    fk, keys, spay = _join_inputs(N, M)
    out, hit = _port_join(fk, keys, spay)
    want_out, want_hit = jops.gather_join_op(
        jnp.asarray(fk), jnp.asarray(keys), jnp.asarray(spay), interpret=True
    )
    _assert_bitwise(out, want_out, "payload")
    _assert_bitwise(hit, np.asarray(want_hit), "hit mask")


def test_gather_join_all_misses_and_all_hits():
    rng = np.random.default_rng(5)
    keys = np.arange(10, dtype=np.int32)
    spay = _dyadic(rng, (10, 2))
    out, hit = _port_join(np.arange(50, dtype=np.int32) + 100, keys, spay)
    assert not hit.any() and not out.any()
    every = np.repeat(keys, 5)
    out2, hit2 = _port_join(every, keys, spay)
    assert hit2.all()
    _assert_bitwise(out2, spay[every], "gathered payload")


# ---------------------------------------------------------------------------
# segment_agg
# ---------------------------------------------------------------------------


def _agg_inputs(N, S):
    rng = np.random.default_rng(N * 100 + S)
    vals = _dyadic(rng, (N, 3))
    w = (rng.random(N) > 1 / 3).astype(np.float32)
    sid = rng.integers(0, S, size=N).astype(np.int32)
    return vals, w, sid


def _port_agg(vals, w, sid, S):
    t = torch.from_numpy
    return tops.segment_agg_op(t(vals), t(w), t(sid), num_segments=S)


@pytest.mark.parametrize("N", [0, 1, 100, 256, 257])
@pytest.mark.parametrize("S", [1, 4, 5])
def test_segment_agg_plain_bitwise_vs_jnp_oracle(N, S):
    vals, w, sid = _agg_inputs(N, S)
    got = _port_agg(vals, w, sid, S)
    want = jref.segment_agg_ref(
        jnp.asarray(vals), jnp.asarray(w), jnp.asarray(sid), num_segments=S
    )
    for g, x, what in zip(got, want, ("counts", "sums", "mins", "maxs")):
        _assert_bitwise(g, x, what)


@pytest.mark.parametrize("S", [1, 5])
def test_segment_agg_plain_bitwise_vs_pallas_interpret(S):
    vals, w, sid = _agg_inputs(257, S)
    got = _port_agg(vals, w, sid, S)
    want = jops.segment_agg_op(
        jnp.asarray(vals), jnp.asarray(w), jnp.asarray(sid),
        num_segments=S, interpret=True,
    )
    for g, x, what in zip(got, want, ("counts", "sums", "mins", "maxs")):
        _assert_bitwise(g, x, what)


def test_segment_agg_all_rows_filtered():
    """w == 0 everywhere: zero counts and sums, +-inf extrema."""
    rng = np.random.default_rng(9)
    vals = _dyadic(rng, (130, 2))
    sid = rng.integers(0, 3, size=130).astype(np.int32)
    counts, sums, mins, maxs = _port_agg(vals, np.zeros(130, np.float32), sid, 3)
    assert not counts.any() and not sums.any()
    assert (mins == np.inf).all() and (maxs == -np.inf).all()


# ---------------------------------------------------------------------------
# dispatch: no quiet fallback between the card and the plain versions
# ---------------------------------------------------------------------------


def test_kernel_mode_token_is_the_ports_own(monkeypatch):
    monkeypatch.setenv("RAVEN_KERNELS", "on")
    on = tops.kernel_mode_token()
    assert tops.kernels_enabled() and on != jops.kernel_mode_token()
    monkeypatch.setenv("RAVEN_KERNELS", "off")
    assert not tops.kernels_enabled()
    assert tops.kernel_mode_token() not in (on, jops.kernel_mode_token())


def test_wrappers_refuse_cpu_tensors_and_ops_refuse_other_devices():
    """A wrapper launches its kernel or raises: it never computes a CPU
    tensor itself. The dispatch refuses devices it has no version for."""
    from repro_torch.kernels.featurize import featurize
    from repro_torch.kernels.relational import gather_join, segment_agg
    from repro_torch.kernels.tree_gemm import tree_gemm

    f = torch.zeros((4, 2))
    i = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        featurize(f, i[:, None], f[0], f[0], i[:0], i[:0])
    with pytest.raises(ValueError, match="CUDA"):
        tree_gemm(f, f[None], f[:1], f[None], f[:1], f[:1], 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        gather_join(i, i, f)
    with pytest.raises(ValueError, match="CUDA"):
        segment_agg(f, f[:, 0], i, num_segments=1)
    meta = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tops.gather_join_op(meta, meta, torch.zeros((4, 1), device="meta"))
