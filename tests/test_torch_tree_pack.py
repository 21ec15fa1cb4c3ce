"""The packed form of a GEMM tree program, which the ``tree_gemm`` CUDA
kernel reads, against the program and against the reference package.

``pack_gemm_program`` turns a padded GEMM program (A one-hot per internal
node, C in {-1, 0, 1}) into per-node (feature, threshold) pairs and per-leaf
left/right bit masks over the nodes. ``packed_plain`` below is the kernel's
algorithm in plain torch (gather, decision bits, mask test, float64 sum over
trees); it is used by nothing on the main path. On hospital programs trained
by the reference package it equals the reference's ``tree_gemm_op`` (the
Pallas kernel in interpret mode) within ``atol=1e-5``: decisions and masks
are exact, and only the sum over trees rounds, in another order. On rows
holding +inf, -inf or NaN it equals the port's plain ``tree_gemm_ref`` within
the same tolerance, with NaN in the same places.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.tensor.tree2tensor import build_gemm_program
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.tree_gemm import (
    PackedGemmProgram,
    decision_words,
    pack_gemm_program,
)
from repro_torch.tensor.compile import compile_pipeline_tensor

TREES = (1, 20, 150)
DEPTHS = (3, 5, 7)
ALIGNS = (8, 136, 176)


def packed_plain(x: torch.Tensor, packed: PackedGemmProgram, base: float) -> torch.Tensor:
    """The kernel's algorithm on the packed program, in plain torch. S is a
    gather of x (a zero column of A, or a feature past x's width, reads 0),
    poisoned as the GEMM form's 0·inf = NaN poisons it: with nf the row's
    non-finite entries, S = x[f] when nf == 0 or when x[f] is the row's only
    one, else NaN. Decisions become bits, each live leaf matches when
    ((dec ^ left) & (left | right)) == 0 over all words, a tree's part is the
    float32 sum of its matched values, and the sum over trees is float64,
    rounded once before ``base`` is added."""
    nodes, leaves, counts = (torch.as_tensor(a) for a in packed)
    N, Fx = x.shape
    T, I, _ = nodes.shape
    L, W = leaves.shape[1], leaves.shape[2] - 1
    feat = nodes[..., 0].long()
    col = torch.where((feat < 0) | (feat >= Fx), Fx, feat)  # (T, I)
    v = torch.cat([x, x.new_zeros((N, 1))], 1)[:, col]  # (N, T, I)
    nf = (~torch.isfinite(x)).sum(1)[:, None, None]
    s = torch.where((nf == 0) | ((nf == 1) & ~torch.isfinite(v)), v, float("nan"))
    thr = nodes[..., 1].contiguous().view(torch.float32)
    dec = (s <= thr) & (torch.arange(I) < counts[:, :1])
    dec = torch.nn.functional.pad(dec, (0, 32 * W - I)).reshape(N, T, W, 32)
    words = (dec.long() << torch.arange(32)).sum(-1)  # (N, T, W)
    left = leaves[:, :, :W, 0].long() & 0xFFFFFFFF  # (T, L, W)
    right = leaves[:, :, :W, 1].long() & 0xFFFFFFFF
    miss = (((words[:, :, None, :] ^ left) & (left | right)) != 0).any(-1)  # (N, T, L)
    live = torch.arange(L) < counts[:, 1:]  # (T, L)
    value = leaves[:, :, W, 0].contiguous().view(torch.float32)
    part = torch.where(~miss & live, value, 0.0).sum(-1)  # (N, T) float32
    return part.double().sum(1).float() + base


@pytest.fixture(scope="module")
def hospital_programs(hospital):
    """depth -> (rows, 150-tree GEMM program) from the reference package's
    trainer and compiler; a program of T trees is its first T trees."""
    from repro.ml import GradientBoostingClassifier

    joined = hospital.joined_columns()
    X = np.stack([joined[c] for c in hospital.numeric], 1).astype(np.float32)
    out = {}
    for depth in DEPTHS:
        gb = GradientBoostingClassifier(n_estimators=max(TREES), max_depth=depth)
        out[depth] = (X[:256], build_gemm_program(gb.fit(X[:256], hospital.label[:256]).ensemble))
    return out


def _program(hospital_programs, T, depth, align):
    X, p = hospital_programs[depth]
    A, B, C, D, V = tops.pad_gemm_program(p.A[:T], p.B[:T], p.C[:T], p.Dcount[:T], p.V[:T],
                                          align=align)
    return X, (A, B, C, D, V), p.base


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("T", TREES)
def test_pack_reads_the_program(hospital_programs, T, depth, align):
    """Features are A's one-hot rows (-1 for a padded column), thresholds
    are B bit for bit, each live leaf's masks are its column's +1 and -1
    entries of C, its value is V's, and the never-leaves are exactly the
    padded ones (Dcount -1)."""
    _, (A, B, C, D, V), _ = _program(hospital_programs, T, depth, align)
    nodes, leaves, counts = pack_gemm_program(A, B, C, D, V)
    I = A.shape[2]
    L, W = C.shape[2], decision_words(I)
    assert nodes.shape == (T, I, 2) and leaves.shape == (T, L, W + 1, 2)
    assert counts.shape == (T, 2) and nodes.dtype == leaves.dtype == np.int32
    nz = A != 0
    want_feat = np.where(nz.any(1), nz.argmax(1), -1)
    assert np.array_equal(nodes[..., 0], want_feat)
    assert np.array_equal(nodes[..., 1], B.view(np.int32))
    bit = np.arange(I)
    for t in range(T):
        real = np.flatnonzero(D[t] >= 0)  # build_gemm_program's leaves
        n = counts[t, 1]
        assert np.array_equal(leaves[t, :n, W, 1], real)
        tail = np.zeros((W + 1, 2), np.int32)
        tail[W, 1] = -1
        assert np.all(leaves[t, n:] == tail)
        masks = leaves[t, :n, :W].astype(np.int64) & 0xFFFFFFFF  # (n, W, 2)
        for k, l in enumerate(real):
            for side, sign in ((0, 1), (1, -1)):
                got = (masks[k, bit // 32, side] >> (bit % 32)) & 1
                assert np.array_equal(got.astype(bool), C[t, :, l] == sign)
        assert np.array_equal(leaves[t, :n, W, 0], V[t, real].view(np.int32))
        tested = np.flatnonzero((C[t][:, real] != 0).any(1))
        assert counts[t, 0] == (tested.max() + 1 if tested.size else 0)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("T", TREES)
def test_packed_algorithm_vs_pallas_interpret(hospital_programs, T, depth):
    """The packed algorithm on the program padded at align 8 (the port's
    compile-time padding) against the reference's Pallas kernel in
    interpret mode on the same padded program, atol 1e-5."""
    X, (A, B, C, D, V), base = _program(hospital_programs, T, depth, 8)
    got = packed_plain(torch.from_numpy(X), pack_gemm_program(A, B, C, D, V), base)
    want = jops.tree_gemm_op(
        jnp.asarray(X), jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
        jnp.asarray(D), jnp.asarray(V), base=base, interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _non_finite_rows(X, rng):
    """Rows of X with +inf, -inf and NaN put in features the trees test and
    in ones they do not (the program's padded feature columns are past x's
    width, so every column of X is a real one), one or two per row."""
    X = X.copy()
    n, F = X.shape
    specials = (np.inf, -np.inf, np.nan)
    for r in range(n):
        kind = r % 4
        if kind == 0:
            continue  # finite
        cols = rng.choice(F, size=1 if kind < 3 else 2, replace=False)
        X[r, cols] = rng.choice(specials, size=cols.size)
    return X


@pytest.mark.parametrize("align", ALIGNS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_packed_algorithm_non_finite_rows(hospital_programs, depth, align):
    """Rows with one or two non-finite entries: the packed algorithm equals
    the plain GEMM chain within 1e-5, with NaN in the same places, and x
    narrower than the program (its padded columns read as zeros)."""
    X, (A, B, C, D, V), base = _program(hospital_programs, 150, depth, align)
    x = torch.from_numpy(_non_finite_rows(X, np.random.default_rng(depth + align)))
    got = packed_plain(x, pack_gemm_program(A, B, C, D, V), base)
    xp = torch.nn.functional.pad(x, (0, A.shape[1] - x.shape[1]))
    t = torch.from_numpy
    want = ref.tree_gemm_ref(xp, t(A), t(B), t(C), t(D), t(V), base)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    # the poisoning changes scores: a row with two non-finite entries decides
    # every node 0, so it differs from the same row made finite
    clean = packed_plain(torch.from_numpy(X), pack_gemm_program(A, B, C, D, V), base)
    assert not torch.equal(got, clean)


def test_non_finite_semantics_against_the_reference_package():
    """One hand-made tree (node 0 tests feature 1, node 1 feature 0, node 2
    a zero column of A) on rows with inf and NaN where the trees look and
    where they do not: the packed algorithm, the port's plain version and
    the reference's Pallas kernel in interpret mode agree exactly."""
    A = np.zeros((1, 4, 3), np.float32)
    A[0, 1, 0] = A[0, 0, 1] = 1.0
    B = np.array([[0.5, 0.0, 1.0]], np.float32)
    # leaves: (n0 left, n1 left), (n0 left, n1 right), (n0 right, n2 left),
    # (n0 right, n2 right)
    C = np.zeros((1, 3, 4), np.float32)
    C[0, 0] = [1, 1, -1, -1]
    C[0, 1, :2] = [1, -1]
    C[0, 2, 2:] = [1, -1]
    D = np.array([[2, 1, 1, 0]], np.float32)
    V = np.array([[1.0, 2.0, 4.0, 8.0]], np.float32)
    inf, nan = np.inf, np.nan
    X = np.array([
        [0.0, 0.0, 0.0], [-1.0, 1.0, 0.0],  # finite
        [0.0, -inf, 0.0], [0.0, inf, 0.0], [0.0, nan, 0.0],  # tested feature
        [0.0, 0.0, inf], [0.0, 0.0, nan],  # untested feature
        [inf, -inf, 0.0], [0.0, 0.0, 0.0],
    ], np.float32)
    want = jops.tree_gemm_op(*map(jnp.asarray, (np.pad(X, ((0, 0), (0, 1))), A, B, C, D, V)),
                             base=0.25, interpret=True)
    got = packed_plain(torch.from_numpy(X), pack_gemm_program(A, B, C, D, V), 0.25)
    plain = tops.tree_gemm_op(*map(torch.from_numpy, (X, A, B, C, D, V)), base=0.25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(want))
    # -inf alone is S = -inf at node 0 (left) and poisons node 1 (right:
    # leaf 1); inf alone goes right; NaN, or an untested non-finite entry,
    # or two of them, decide 0 everywhere (leaf 3)
    assert got.tolist() == [1.25, 4.25, 2.25, 8.25, 8.25, 8.25, 8.25, 8.25, 1.25]


def _tiny_program():
    """Two trees of two leaves over F = 3 features, padded to align 8."""
    A = np.zeros((2, 3, 1), np.float32)
    A[0, 2, 0] = A[1, 0, 0] = 1.0
    B = np.array([[0.5], [-0.5]], np.float32)
    C = np.array([[[1, -1]], [[1, -1]]], np.float32)
    D = np.array([[1, 0], [1, 0]], np.float32)
    V = np.array([[1, 2], [3, 4]], np.float32)
    return list(tops.pad_gemm_program(A, B, C, D, V))


@pytest.mark.parametrize("edit,message", [
    (lambda p: p[0].__setitem__((1, 2, 0), 1.0), "tree 1 node 0: column of A has 2"),
    (lambda p: p[0].__setitem__((0, 2, 0), 0.5), r"tree 0 node 0: A\[0, 2, 0\] = 0.5"),
    (lambda p: p[2].__setitem__((1, 0, 1), 2.0), r"tree 1 leaf 1: C\[1, 0, 1\] = 2.0"),
    (lambda p: p[3].__setitem__((0, 1), -1.0), "tree 0 leaf 1: Dcount -1.0 is attainable"),
    (lambda p: p[3].__setitem__((1, 0), 0.0), "tree 1 leaf 0: Dcount 0.0 is attainable"),
    (lambda p: p[4].__setitem__((0, 5), np.inf), "tree 0 leaf 5: value inf"),
])
def test_pack_refuses_programs_outside_its_exactness_conditions(edit, message):
    prog = _tiny_program()
    pack_gemm_program(*prog)  # the unedited program packs
    edit(prog)
    with pytest.raises(ValueError, match=message):
        pack_gemm_program(*prog)


def test_pack_leaves_out_unattainable_leaves():
    """A Dcount that no decisions can reach (padding's -1 on a zero column,
    a fraction, a count above the +1 entries, NaN) marks a never-leaf."""
    A, B, C, D, V = _tiny_program()
    D[0, 0], D[1, 0] = 0.5, np.nan
    D[1, 1] = 2.0  # leaf 1 of tree 1 has no +1 entry
    _, leaves, counts = pack_gemm_program(A, B, C, D, V)
    assert counts.tolist() == [[1, 1], [0, 0]]
    assert leaves[0, 0, 1, 1] == 1 and leaves[0, 1, 1, 1] == -1


def test_compiled_gemm_program_holds_the_packed_buffers(hospital):
    """A GEMM ``TensorProgram`` packs its padded program once, at compile
    time, into int32 buffers beside A…V, so ``.to()`` moves them with it."""
    from repro_torch.data.datasets import make_hospital
    from repro_torch.ml import GradientBoostingClassifier, fit_pipeline

    ds = make_hospital(512, seed=1)
    pipe = fit_pipeline(ds.joined_columns(), ds.label, ds.numeric, ds.categorical,
                        GradientBoostingClassifier(n_estimators=4, max_depth=3),
                        categories=ds.categories())
    prog = compile_pipeline_tensor(pipe, strategy="gemm", device="cpu").fn
    g = next(info for kind, _, info in prog.steps if kind == "trees")["gemm"]
    bufs = dict(prog.named_buffers())
    want = pack_gemm_program(*(bufs[g[k]].numpy() for k in "ABCDV"))
    assert len(g["packed"]) == len(want) == 3
    for name, arr in zip(g["packed"], want):
        assert bufs[name].dtype == torch.int32 and np.array_equal(bufs[name].numpy(), arr)
    moved = prog.to("meta")
    assert all(dict(moved.named_buffers())[n].device.type == "meta" for n in g["packed"])
