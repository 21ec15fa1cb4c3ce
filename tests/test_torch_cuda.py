"""The port's CUDA kernels on the card, held against their plain versions.

These need an NVIDIA card (the kernels have no CPU mode): they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. On a
machine with a card, run them with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. ``featurize``, ``gather_join`` and
``segment_agg`` must equal their plain versions bitwise (dyadic data for
``segment_agg``); ``tree_gemm`` within ``atol=1e-5`` (another order of the
sum over trees).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels._build import LAUNCHES

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy().astype(np.float32)).view(np.uint32)


def _dyadic(rng, shape):
    return (rng.integers(-40, 40, size=shape) * 0.25).astype(np.float32)


@pytest.mark.parametrize("N", [0, 1, 257, 100_000])
@pytest.mark.parametrize("n_num,segs", [(9, (3, 7, 2, 5)), (4, ()), (0, (3, 5))])
def test_featurize_kernel_bitwise(dev, n_num, segs, N):
    rng = np.random.default_rng(N + n_num)
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    num = t(rng.normal(size=(N, n_num)), torch.float32)
    cat = t(np.stack([rng.integers(-1, s, N) for s in segs], 1)
            if segs else np.zeros((N, 0)), torch.int32)
    offset = t(rng.normal(size=n_num), torch.float32)
    scale = t(rng.uniform(0.5, 2.0, size=n_num), torch.float32)
    values = t(np.concatenate([np.arange(s) for s in segs] or [np.zeros(0)]),
               torch.int32)
    starts = np.cumsum([0] + list(segs))[:-1]
    segments = tuple((int(s), int(l)) for s, l in zip(starts, segs))
    before = LAUNCHES["featurize"]
    got = ops.featurize_op(num, cat, offset, scale, values, segments)
    want = ref.featurize_ref(num, cat, offset, scale, values, segments)
    assert LAUNCHES["featurize"] == before + (1 if got.numel() else 0)
    assert got.is_cuda and np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("T,depth", [(1, 3), (20, 5), (150, 5)])
def test_tree_gemm_kernel_within_1e5(dev, T, depth):
    from repro_torch.data.datasets import make_hospital
    from repro_torch.ml import GradientBoostingClassifier
    from repro_torch.tensor.tree2tensor import build_gemm_program

    ds = make_hospital(1024, seed=1)
    cols = ds.joined_columns()
    X = np.stack([cols[c] for c in ds.numeric], 1).astype(np.float32)
    gb = GradientBoostingClassifier(n_estimators=T, max_depth=depth).fit(X, ds.label)
    p = build_gemm_program(gb.ensemble)
    A, B, C, D, V = (torch.tensor(a, device=dev) for a in
                     ops.pad_gemm_program(p.A, p.B, p.C, p.Dcount, p.V))
    x = torch.tensor(X, device=dev)  # 9 features; the padded program has 16
    before = LAUNCHES["tree_gemm"]
    got = ops.tree_gemm_op(x, A, B, C, D, V, base=p.base)
    xp = torch.nn.functional.pad(x, (0, A.shape[1] - x.shape[1]))
    want = ref.tree_gemm_ref(xp, A, B, C, D, V, p.base)
    assert LAUNCHES["tree_gemm"] == before + 1
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("N,M", [(0, 7), (1, 1), (257, 130), (1 << 20, 1 << 16)])
def test_gather_join_kernel_bitwise(dev, N, M):
    rng = np.random.default_rng(N + M)
    keys = torch.tensor(np.sort(rng.choice(3 * M, size=M, replace=False)),
                        dtype=torch.int32, device=dev)
    fk = torch.tensor(rng.integers(0, 3 * M, size=N), dtype=torch.int32, device=dev)
    spay = torch.tensor(_dyadic(rng, (M, 3)), device=dev)
    out, hit = ops.gather_join_op(fk, keys, spay)
    want_out, want_hit = ref.gather_join_ref(fk, keys, spay)
    assert np.array_equal(_bits(out), _bits(want_out))
    assert torch.equal(hit, want_hit)


@pytest.mark.parametrize("N,S,C", [(0, 1, 3), (257, 5, 3), (100_000, 1, 1),
                                   (1 << 20, 8, 3), (5000, 1, 0)])
def test_segment_agg_kernel_bitwise_and_repeatable(dev, N, S, C):
    rng = np.random.default_rng(N + S)
    vals = torch.tensor(_dyadic(rng, (N, C)), device=dev)
    w = torch.tensor((rng.random(N) > 1 / 3).astype(np.float32), device=dev)
    sid = torch.tensor(rng.integers(0, S, size=N), dtype=torch.int32, device=dev)
    got = ops.segment_agg_op(vals, w, sid, num_segments=S)
    want = ref.segment_agg_ref(vals, w, sid, num_segments=S)
    for g, x in zip(got, want):
        assert np.array_equal(_bits(g), _bits(x))
    # no float atomics: non-dyadic data sums in the same order every run
    noisy = torch.tensor(rng.normal(size=(N, C)), dtype=torch.float32, device=dev)
    a = ops.segment_agg_op(noisy, w, sid, num_segments=S)
    b = ops.segment_agg_op(noisy, w, sid, num_segments=S)
    for x, y in zip(a, b):
        assert np.array_equal(_bits(x), _bits(y))


def test_hospital_query_on_the_card_matches_the_cpu(dev):
    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
    from repro_torch.data.datasets import make_hospital
    from repro_torch.ml import GradientBoostingClassifier, fit_pipeline, run_pipeline
    from repro_torch.relational.engine import compile_plan
    from repro_torch.sql.parser import parse_prediction_query

    train, infer = make_hospital(1024, seed=0), make_hospital(5000, seed=0)
    pipe = fit_pipeline(
        train.joined_columns(), train.label, train.numeric, train.categorical,
        GradientBoostingClassifier(n_estimators=10, max_depth=3),
        categories=train.categories(),
    )
    sql = ("SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) "
           "AS p WHERE asthma = 1 AND score >= :t")
    q = parse_prediction_query(sql, {"m": pipe}, infer.tables)
    plan, _ = RavenOptimizer(options=OptimizerOptions(transform="dnn")).optimize(q)
    cp = compile_plan(plan)
    # bind :t mid-way in a wide gap between scores, so last-bit differences
    # between the two devices cannot move a row across it
    cols = infer.joined_columns()
    s = np.unique(run_pipeline(pipe, {n: cols[n] for n in pipe.input_names()})[pipe.outputs[0]])
    i = len(s) // 2 + int(np.argmax(np.diff(s[len(s) // 2:][:1001])))
    assert s[i + 1] - s[i] >= 2e-5
    t = float((s[i] + s[i + 1]) / 2)
    # one plan, run on the card (GEMM through the kernels), then on the CPU
    # (traversal), then on the card again
    counts = (LAUNCHES["featurize"], LAUNCHES["tree_gemm"], LAUNCHES["segment_agg"])
    got = cp.run(infer.tables, params={"t": t}).table
    assert got.valid.is_cuda
    got = got.to_numpy()
    after = (LAUNCHES["featurize"], LAUNCHES["tree_gemm"], LAUNCHES["segment_agg"])
    assert all(a > b for a, b in zip(after, counts))
    want = cp.run(infer.tables, params={"t": t}, device="cpu").table.to_numpy()
    assert LAUNCHES["tree_gemm"] == after[1]
    again = cp.run(infer.tables, params={"t": t}).table.to_numpy()
    assert LAUNCHES["tree_gemm"] == after[1] + 1
    assert np.array_equal(got["count_rows"], want["count_rows"])
    np.testing.assert_allclose(got["mean_score"], want["mean_score"], rtol=1e-5)
    for k in got:
        assert np.array_equal(got[k], again[k])


def test_tree_gemm_kernel_wide_program_in_feature_chunks(dev):
    """A program too wide for one block's shared memory (2,000 features,
    I = L = 136 columns: the most the GEMM policy picks) runs in feature
    chunks. Its trees are a real ensemble's, with their features scattered
    among 2,000 and inert node columns added, so the result equals the
    narrow program's bit for bit and the plain version's within 1e-5."""
    from repro_torch.data.datasets import make_hospital
    from repro_torch.kernels.tree_gemm import feature_chunk
    from repro_torch.ml import GradientBoostingClassifier
    from repro_torch.tensor.tree2tensor import build_gemm_program

    ds = make_hospital(2048, seed=3)
    cols = ds.joined_columns()
    X = np.stack([cols[c] for c in ds.numeric], 1).astype(np.float32)
    gb = GradientBoostingClassifier(n_estimators=12, max_depth=7).fit(X, ds.label)
    p = build_gemm_program(gb.ensemble)
    narrow = ops.pad_gemm_program(p.A, p.B, p.C, p.Dcount, p.V)
    A, B, C, D, V = ops.pad_gemm_program(p.A, p.B, p.C, p.Dcount, p.V, align=136)
    Fw = 2000
    rng = np.random.default_rng(0)
    pos = rng.choice(Fw, size=X.shape[1], replace=False)
    Aw = np.zeros((A.shape[0], Fw, A.shape[2]), np.float32)
    Aw[:, pos, :] = A[:, : X.shape[1], :]
    Xw = rng.normal(size=(X.shape[0], Fw)).astype(np.float32)
    Xw[:, pos] = X
    assert A.shape[2] == C.shape[2] == 136 and feature_chunk(Fw, 136, 136) < Fw
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    wide = ops.tree_gemm_op(t(Xw), t(Aw), t(B), t(C), t(D), t(V), base=p.base)
    small = ops.tree_gemm_op(t(X), *map(t, narrow), base=p.base)
    want = ref.tree_gemm_ref(t(Xw), t(Aw), t(B), t(C), t(D), t(V), p.base)
    assert np.array_equal(_bits(wide), _bits(small))
    assert float((wide - want).abs().max()) <= 1e-5
