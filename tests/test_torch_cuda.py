"""The port's CUDA kernels on the card, held against their plain versions.

These need an NVIDIA card (the kernels have no CPU mode): they carry the
``cuda`` marker and skip where ``torch.cuda.is_available()`` is false. On a
machine with a card, run them with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. ``featurize``, ``gather_join`` and
``segment_agg`` must equal their plain versions bitwise (dyadic data for
``segment_agg``); ``tree_gemm`` within ``atol=1e-5`` (another order of the
sum over trees); the two attention kernels within ``atol=2e-5`` in float32
and ``2e-2`` in bfloat16 (the reference's kernel-sweep tolerances: the
online softmax sums in another order than the plain version's full one).
Capture and serving on the card: every plan of the main path captured
(one CUDA graph a pure stage and shape) equals its eager run bitwise, a
``segment_agg`` stage replays 50 times bitwise, the captured decode tick
serves the eager tick's tokens, the served hospital query equals its
one-shot call and a warm bucket captures nothing, and a lazy cache or a
host read reached while capturing raises. Persistence and lifecycle: a warm
start from the artifact store captures its buckets at registration and none
on the request path (bitwise the cold run), a warmed version's cutover
captures nothing, a ladder past the capture cache's capacity shows as a
warm deficit, a one-shot call on a stored but not preloaded bucket counts
its capture, and a kernel's launch error fails its requests without
tripping the breaker. The moe family: both attention kernels at
qwen2-moe-a2.7b's serving shapes (H = KH = 16, D = 128, bf16), ``moe_ffn``
on the card against its CPU run (both dispatch variants, capacity drops, a
captured decode shape), and the static-analysis gate on the card. The
recurrent families: ``flash_attention`` with a sliding window against its
plain version (D of 64, 112 and 128, windows below and above S, at
zamba2-7b's 8,192-token prefill), ``decode_attention`` at zamba2-7b's tick
(D = 112, G = 1), and the reduced xlstm-350m and zamba2-7b (head dim 112)
prefilled and decoded on the card against their CPU run. The vlm and encdec
families: both attention kernels at G = 7 (llava-next-34b's H = 56 over
KH = 8) and at whisper-small's D = 64 (the 1,500-row encoder, cross
attention of 4 and 224 queries over 1,500 rows, decode over the 1,500-row
cross cache); the reduced llava and whisper on the card against their CPU
run, and both at their published widths on the kernels against plain
attention. The attention kernels as registered operators (the dry run's
route): each launches through ``torch.ops.repro_torch``, bitwise its ctypes
wrapper, counted by ``FlopCounterMode``; under ``FakeTensorMode`` nothing
launches.
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


def _featurize_columns(rng, N, n_num, segs, dev):
    """In-place inputs of every layout the kernel reads: numeric columns as
    1-D tensors, one a stride-2 view, and two of them as one (N, 2) view of
    a wider tensor; categorical codes as 1-D int32 tensors, one a column of
    an (N, 3) tensor (stride 3), and one int64 (converted on its own)."""
    t = lambda a, dt: torch.tensor(a, dtype=dt, device=dev)  # noqa: E731
    wide = t(rng.normal(size=(N, 5)), torch.float32)
    num = [wide[:, 3:5]] + [t(rng.normal(size=N), torch.float32) for _ in range(n_num - 3)]
    num.append(t(rng.normal(size=2 * N), torch.float32)[::2])
    codes = [rng.integers(-1, s, N) for s in segs]
    cat = [t(c, torch.int32) for c in codes[2:]]
    if len(segs) >= 2:
        block = t(np.stack([codes[0], codes[0] + 1, codes[0] + 2], 1), torch.int32)
        cat = [block[:, 0], t(codes[1], torch.int64)] + cat
    offset = t(rng.normal(size=n_num), torch.float32)
    scale = t(rng.uniform(0.5, 2.0, size=n_num), torch.float32)
    values = t(np.concatenate([np.arange(s) for s in segs]), torch.int32)
    starts = np.cumsum([0] + list(segs))[:-1]
    segments = tuple((int(s), int(l)) for s, l in zip(starts, segs))
    return num, cat, offset, scale, values, segments


def _featurize_plain(num, cat, offset, scale, values, segments):
    N = num[0].shape[0]
    return ref.featurize_ref(ops.stack_columns(num, N, torch.float32),
                             ops.stack_columns(cat, N, torch.int32),
                             offset, scale, values, segments)


@pytest.mark.parametrize("N,n_num,segs", [
    (100_000, 9, (3, 2, 4, 3, 2, 2, 3, 3, 4, 2, 3, 4, 3, 2)),  # the hospital query's
    (8192, 8, (198,) * 19 + (195,)),  # Expedia's width: 3,965 columns, a 4-row tile
    (300, 4, (9000, 6000)),  # too wide for a tile: the stream path
    (1001, 70, (2,) * 70),  # 140 inputs: four launches of disjoint column ranges
])
def test_featurize_kernel_reads_columns_in_place(dev, N, n_num, segs):
    from repro_torch.kernels.featurize import FEAT_MAX_COLS, featurize_launches

    rng = np.random.default_rng(N)
    args = _featurize_columns(rng, N, n_num, segs, dev)
    before = LAUNCHES["featurize"]
    got = ops.featurize_op(*args)
    launches = 1 if n_num + len(segs) <= FEAT_MAX_COLS else len(featurize_launches(n_num, segs))
    assert LAUNCHES["featurize"] == before + launches
    want = _featurize_plain(*args)
    assert got.shape == (N, n_num + sum(segs))
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(ops.featurize_op(*args)), _bits(got))


def test_featurize_kernel_replays_in_a_cuda_graph(dev):
    """The launch does no host work a capture would miss: replays of a
    captured call, beside eager calls, equal the plain version. ``val_col``
    is made before the capture, as a compiled program holds it."""
    from repro_torch.kernels.featurize import segment_columns

    rng = np.random.default_rng(4)
    args = _featurize_columns(rng, 50_000, 9, (3, 2, 4, 3), dev)
    val_col = segment_columns(args[-1], dev)
    want = _featurize_plain(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.featurize_op(*args, val_col=val_col)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.featurize_op(*args, val_col=val_col) for _ in range(3)]
    for _ in range(2):
        graph.replay()
        eager = ops.featurize_op(*args, val_col=val_col)
        torch.cuda.synchronize()
        for got in (*outs, eager):
            assert np.array_equal(_bits(got), _bits(want))


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
    # one plan, run on the card (GEMM through the kernels, captured), then on
    # the CPU (traversal), then on the card again: a replay of the graph, one
    # tree_gemm launch (the tables are uploaded once, so the graph reads them
    # where they lie)
    from repro_torch.relational.engine import upload_database

    db = upload_database(infer.tables, dev)
    counts = (LAUNCHES["featurize"], LAUNCHES["tree_gemm"], LAUNCHES["segment_agg"])
    got = cp.run(db, params={"t": t}).table
    assert got.valid.is_cuda
    got = got.to_numpy()
    after = (LAUNCHES["featurize"], LAUNCHES["tree_gemm"], LAUNCHES["segment_agg"])
    assert all(a > b for a, b in zip(after, counts))
    want = cp.run(infer.tables, params={"t": t}, device="cpu").table.to_numpy()
    assert LAUNCHES["tree_gemm"] == after[1]
    again = cp.run(db, params={"t": t}).table.to_numpy()
    assert LAUNCHES["tree_gemm"] == after[1] + 1
    assert np.array_equal(got["count_rows"], want["count_rows"])
    np.testing.assert_allclose(got["mean_score"], want["mean_score"], rtol=1e-5)
    for k in got:
        assert np.array_equal(got[k], again[k])


def test_tree_gemm_kernel_wide_program_in_feature_chunks(dev):
    """A program too wide for one block's shared memory (2,000 features,
    I = L = 136 columns: the most the GEMM policy picks) runs with x read
    through L1 instead of staged. Its trees are a real ensemble's, with their features scattered
    among 2,000 and inert node columns added, so the result equals the
    narrow program's bit for bit and the plain version's within 1e-5."""
    from repro_torch.data.datasets import make_hospital
    from repro_torch.kernels.tree_gemm import launch_plan
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
    assert A.shape[2] == C.shape[2] == 136 and not launch_plan(Fw, A.shape[0], 136, 136)[0]
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    wide = ops.tree_gemm_op(t(Xw), t(Aw), t(B), t(C), t(D), t(V), base=p.base)
    small = ops.tree_gemm_op(t(X), *map(t, narrow), base=p.base)
    want = ref.tree_gemm_ref(t(Xw), t(Aw), t(B), t(C), t(D), t(V), p.base)
    assert np.array_equal(_bits(wide), _bits(small))
    assert float((wide - want).abs().max()) <= 1e-5


def _hospital_trees(n_estimators, max_depth, seed):
    from repro_torch.data.datasets import make_hospital
    from repro_torch.ml import GradientBoostingClassifier
    from repro_torch.tensor.tree2tensor import build_gemm_program

    ds = make_hospital(1024, seed=seed)
    cols = ds.joined_columns()
    X = np.stack([cols[c] for c in ds.numeric], 1).astype(np.float32)
    gb = GradientBoostingClassifier(n_estimators=n_estimators, max_depth=max_depth)
    return X, build_gemm_program(gb.fit(X, ds.label).ensemble)


@pytest.mark.parametrize("align,W,wide", [(8, 1, False), (64, 2, False), (136, 5, False),
                                          (136, 5, True), (176, 6, False)])
def test_tree_gemm_kernel_non_finite_rows_and_repeatable(dev, align, W, wide):
    """Rows with +inf, -inf and NaN, one or two a row, in features the trees
    test and in ones they do not: the kernel equals the plain version within
    1e-5 with NaN in the same places (the GEMM form's 0 * inf = NaN poisons
    a row's other nodes), for W = 1, 2, 5 and 6 decision words, with x staged
    in shared memory and (wide: 2,000 features) read through L1. A second
    call repeats the first bit for bit."""
    from repro_torch.kernels.tree_gemm import decision_words, launch_plan

    X, p = _hospital_trees(20, 5, seed=2)
    A, B, C, D, V = ops.pad_gemm_program(p.A, p.B, p.C, p.Dcount, p.V, align=align)
    assert decision_words(A.shape[2]) == W
    rng = np.random.default_rng(align + wide)
    used = np.arange(X.shape[1])
    if wide:
        Fw = 2000
        used = rng.choice(Fw, size=X.shape[1], replace=False)
        Aw = np.zeros((A.shape[0], Fw, A.shape[2]), np.float32)
        Aw[:, used, :] = A[:, : X.shape[1], :]
        Xw = rng.normal(size=(X.shape[0], Fw)).astype(np.float32)
        Xw[:, used] = X
        A, X = Aw, Xw
    for r in range(X.shape[0]):
        if r % 4:
            pool = used if r % 8 < 4 else np.arange(X.shape[1])
            cols = rng.choice(pool, size=1 if r % 4 < 3 else 2, replace=False)
            X[r, cols] = rng.choice([np.inf, -np.inf, np.nan], size=cols.size)
    assert launch_plan(X.shape[1], A.shape[0], A.shape[2], C.shape[2])[0] == (not wide)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    x, prog = t(X), [t(a) for a in (A, B, C, D, V)]
    got = ops.tree_gemm_op(x, *prog, base=p.base)
    again = ops.tree_gemm_op(x, *prog, base=p.base)
    xp = torch.nn.functional.pad(x, (0, A.shape[1] - x.shape[1]))
    want = ref.tree_gemm_ref(xp, *prog, p.base)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-5
    assert np.array_equal(_bits(got), _bits(again))


def test_compiled_plan_reaches_the_kernel_with_its_packed_program(dev, monkeypatch):
    """``compile_plan`` → ``run`` on the card: the GEMM step hands the kernel
    the program packed at compile time (packing per call raises here). The
    first run calls the step twice, in the eager warm-up (one launch) and in
    the capture (no launch), and replays the graph (one launch); a second
    run replays only: one launch, no Python call of the wrapper."""
    import repro_torch.kernels.tree_gemm as tg
    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
    from repro_torch.data.datasets import make_hospital
    from repro_torch.ml import GradientBoostingClassifier, fit_pipeline
    from repro_torch.relational.engine import compile_plan
    from repro_torch.sql.parser import parse_prediction_query

    train, infer = make_hospital(1024, seed=0), make_hospital(3000, seed=1)
    pipe = fit_pipeline(
        train.joined_columns(), train.label, train.numeric, train.categorical,
        GradientBoostingClassifier(n_estimators=10, max_depth=5),
        categories=train.categories(),
    )
    sql = "SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) AS p"
    q = parse_prediction_query(sql, {"m": pipe}, infer.tables)
    plan, _ = RavenOptimizer(options=OptimizerOptions(transform="dnn")).optimize(q)
    cp = compile_plan(plan)
    seen = []
    real = tg.tree_gemm
    monkeypatch.setattr(tg, "tree_gemm", lambda *a: seen.append(a[7]) or real(*a))
    monkeypatch.setattr(tg, "packed_on", lambda *a: pytest.fail("packed per call"))
    from repro_torch.relational.engine import upload_database

    db = upload_database(infer.tables, dev)
    before = LAUNCHES["tree_gemm"]
    out = cp.run(db).table.to_numpy()
    assert LAUNCHES["tree_gemm"] == before + 2
    assert len(seen) == 2 and isinstance(seen[0], tg.PackedGemmProgram)
    assert all(a is b for a, b in zip(*seen))  # the same packed tensors
    assert all(a.is_cuda and a.dtype == torch.int32 for a in seen[0])
    assert out["count_rows"].tolist() == [3000]
    assert cp.run(db).table.to_numpy()["count_rows"].tolist() == [3000]
    assert LAUNCHES["tree_gemm"] == before + 3 and len(seen) == 2


# ---------------------------------------------------------------------------
# segment_agg in one launch, gather_join's two routes, tree_gemm's wide path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,S,C,sorted_ids", [
    (1 << 20, 8, 3, False), (1 << 20, 6, 3, True), (1 << 20, 1, 3, False),
    (100_000, 1, 1, False), (4099, 2, 0, False), (0, 8, 3, False), (50_000, 256, 3, False),
    (20_000, 1024, 3, True), (30_000, 1, 5, False), (3000, 3, 70, False),
    (1000, 70_000, 1, False),
])
def test_segment_agg_kernel_matches_its_model_bitwise(dev, N, S, C, sorted_ids):
    """Strided columns read in place, non-dyadic values: the kernel equals
    ``tests/torch_agg_model.py`` bit for bit on the register path (S <= 8,
    C <= 3; segment ids random, or sorted as coalesced requests come, in
    long runs) and the shared path (more segments or columns, in groups past
    what shared memory holds), one launch per 64 columns, two calls alike;
    on dyadic data it equals the plain version bitwise."""
    from repro_torch.kernels._build import sm_count
    from torch_agg_model import segment_agg_model

    rng = np.random.default_rng(N + S + C)
    base = torch.tensor(rng.random(size=(N, C + 1)), dtype=torch.float32, device=dev)
    cols = list(base[:, :C].unbind(1))  # stride C + 1
    w = torch.tensor((rng.random(N) > 0.3).astype(np.float32), device=dev)
    ids = rng.integers(0, S, size=N)
    sid = torch.tensor(np.sort(ids) if sorted_ids else ids, dtype=torch.int32, device=dev)
    before = LAUNCHES["segment_agg"]
    got = ops.segment_agg_op(cols, w, sid, num_segments=S)
    assert LAUNCHES["segment_agg"] == before + max(1, -(-C // 64))
    assert all(torch.equal(x, y) for x, y in
               zip(got, ops.segment_agg_op(cols, w, sid, num_segments=S)))
    vals = base[:, :C].cpu()
    parts = [segment_agg_model(vals[:, k:k + 64], w.cpu(), sid.cpu(), num_segments=S,
                               sms=sm_count(dev)) for k in range(0, max(C, 1), 64)]
    want = (parts[0][0], *(torch.cat([p[i] for p in parts], dim=1) for i in (1, 2, 3)))
    for g, x in zip(got, want):
        assert np.array_equal(_bits(g), _bits(x))
    dy = torch.tensor(_dyadic(rng, (N, C)), device=dev)
    got = ops.segment_agg_op(dy, w, None if S == 1 else sid, num_segments=S)
    for g, x in zip(got, ref.segment_agg_ref(dy, w, sid, num_segments=S)):
        assert np.array_equal(_bits(g), _bits(x))
    if C and N:  # inf and NaN, on rows of weight 0 too (0 * inf is NaN)
        base[::997, 0] = float("inf")
        base[5::1009, C - 1] = float("nan")
        got = ops.segment_agg_op(cols, w, sid, num_segments=S)
        want = segment_agg_model(base[:, :C].cpu()[:, :64], w.cpu(), sid.cpu(),
                                 num_segments=S, sms=sm_count(dev))
        for g, x in zip(got, want):
            g, x = g[:, :64] if g.dim() == 2 else g, x
            assert torch.equal(torch.isnan(g.cpu()), torch.isnan(x))
            keep = ~torch.isnan(x)
            assert np.array_equal(_bits(g.cpu()[keep]), _bits(x[keep]))


def test_segment_agg_kernel_replays_in_a_cuda_graph(dev):
    """The last block resets the completion counter it used, so a captured
    call replays correctly, again and again, beside eager calls."""
    rng = np.random.default_rng(3)
    n = 300_000
    vals = torch.tensor(_dyadic(rng, (n, 3)), device=dev)
    w = torch.tensor((rng.random(n) > 0.5).astype(np.float32), device=dev)
    sid = torch.tensor(rng.integers(0, 8, size=n), dtype=torch.int32, device=dev)
    want = ref.segment_agg_ref(vals, w, sid, num_segments=8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.segment_agg_op(vals, w, sid, num_segments=8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [ops.segment_agg_op(vals, w, sid, num_segments=8) for _ in range(3)]
    for _ in range(2):
        graph.replay()
        eager = ops.segment_agg_op(vals, w, sid, num_segments=8)
        torch.cuda.synchronize()
        for got in (*outs, eager):
            for g, x in zip(got, want):
                assert np.array_equal(_bits(g), _bits(x))


JOIN_KEYS = {  # name -> (dim keys, has a dense index)
    "dense": (np.setdiff1d(np.arange(1 << 16), np.arange(0, 1 << 16, 5)), True),
    "sparse": (np.random.default_rng(1).choice(1 << 28, 1 << 16, replace=False), False),
    "negative": (np.arange(-3000, 3000, 2), True),
    "int32_limits": (np.array([-(2**31), -(2**31) + 3, 2**31 - 2, 2**31 - 1]), False),
    "int32_low": (np.arange(-(2**31), -(2**31) + 4000, 3), True),
    "single": (np.array([7]), True),
    "empty": (np.zeros(0), False),
}


@pytest.mark.parametrize("name", sorted(JOIN_KEYS))
def test_gather_join_kernel_routes_bitwise(dev, name):
    """The dimsort entry on the card holds a direct-address index exactly
    where the keys' range allows; both routes (records built from the
    index, and the search with its top levels in shared memory) equal the
    plain version bitwise, misses and keys at the int32 limits included."""
    from repro_torch.kernels.relational import dense_records
    from repro_torch.relational.engine import dimsort_entry

    keys, dense = JOIN_KEYS[name]
    keys = keys.astype(np.int32)
    rng = np.random.default_rng(len(name))
    entry = dimsort_entry(rng.permutation(keys), dev)
    assert ("index" in entry) == dense
    M = keys.size
    fk = np.concatenate([rng.choice(keys, 1 << 19) if M else np.zeros(0, np.int64),
                         rng.integers(-(2**31), 2**31, 1 << 18),
                         [-(2**31), 2**31 - 1, 0, -1]]).astype(np.int32)
    fk = torch.tensor(fk, device=dev)
    spay = torch.tensor(_dyadic(rng, (M, 2)), device=dev)
    want = ref.gather_join_ref(fk, entry["keys"], spay)
    routes = [ops.gather_join_op(fk, entry["keys"], spay)]
    if dense:
        records = dense_records(entry["index"], spay)
        routes.append(ops.gather_join_op(fk, entry["keys"], spay, records=records,
                                         lo=entry["lo"]))
    for out, hit in routes:
        assert np.array_equal(_bits(out), _bits(want[0])) and torch.equal(hit, want[1])


def test_join_step_on_the_card_reads_the_index_and_a_payload_built_once(dev, monkeypatch):
    """The dashboard join on an uploaded database: the op gets the dense
    records built from the dimsort entry's index, and the same sorted
    payload and records on every run. The runs are eager
    (``capture.disabled()``): a replay calls no Python step."""
    from repro_torch.exec import capture
    from repro_torch.relational import engine as teng
    from repro_torch.relational.expr import Bin, Col, Const

    rng = np.random.default_rng(4)
    tables = {"d": {"k": np.arange(1000, dtype=np.int64), "v": _dyadic(rng, 1000)},
              "f": {"fk": rng.integers(0, 1250, 50_000).astype(np.int64),
                    "x": _dyadic(rng, 50_000)}}
    plan = teng.Aggregate(
        teng.Filter(teng.Join(teng.Scan("f", ["fk", "x"]), "d", "fk", "k", ["v"]),
                    Bin("gt", Col("x"), Const(0.0))),
        [("n", "count", "x"), ("s", "sum", "v"), ("m", "min", "v")])
    calls = []
    real = ops.gather_join_op
    monkeypatch.setattr(ops, "gather_join_op",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    db = teng.upload_database(tables, dev)
    cp = teng.compile_plan(plan, cache=False)
    before = LAUNCHES["gather_join"]
    with capture.disabled():
        outs = [cp.run(db).table.to_numpy() for _ in range(2)]
    host = teng.compile_plan(plan, cache=False).run(tables, device="cpu").table.to_numpy()
    assert LAUNCHES["gather_join"] == before + 2
    (a0, k0), (a1, k1) = calls[:2]
    assert a0[2] is a1[2] and k0["records"] is k1["records"]
    assert (a0[2], k0["records"]) == db.dimsort("d", "k")["payloads"][("v",)]
    for out in outs:
        for k in host:
            assert np.array_equal(_bits(torch.from_numpy(out[k])),
                                  _bits(torch.from_numpy(host[k]))), k


def _full_tree_program(T, depth, F, rng):
    """T full binary trees of the given depth as a GEMM program (nodes in
    breadth-first order, node i's children 2i + 1 (x <= threshold) and
    2i + 2)."""
    I, L = 2**depth - 1, 2**depth
    A = np.zeros((T, F, I), np.float32)
    feats = rng.integers(0, F, size=(T, I))
    for t in range(T):
        A[t, feats[t], np.arange(I)] = 1.0
    B = rng.normal(size=(T, I)).astype(np.float32)
    C = np.zeros((T, I, L), np.float32)
    D = np.zeros((T, L), np.float32)
    for leaf in range(L):
        node = 0
        for j in range(depth):
            right = (leaf >> (depth - 1 - j)) & 1
            C[:, node, leaf] = -1.0 if right else 1.0
            D[:, leaf] += 0.0 if right else 1.0
            node = 2 * node + 1 + right
    V = rng.normal(size=(T, L)).astype(np.float32)
    return A, B, C, D, V


@pytest.mark.parametrize("depth", [8, 10])
def test_tree_gemm_kernel_wide_path_full_trees(dev, depth):
    """Full trees of depth 8 (255 internal nodes, 8 decision words once
    padded) and 10 (1,023 nodes, 32 words) run on the wide path within 1e-5
    of the plain version, rows with +inf, -inf and NaN included (NaN in the
    same places), two calls bit for bit alike."""
    from repro_torch.kernels.tree_gemm import decision_words, launch_plan

    rng = np.random.default_rng(depth)
    F = 20
    A, B, C, D, V = ops.pad_gemm_program(*_full_tree_program(4, depth, F, rng))
    assert decision_words(A.shape[2]) > 6 and launch_plan(F, 4, A.shape[2], C.shape[2])[1] == 0
    X = rng.normal(size=(3000, F)).astype(np.float32)
    for r in range(0, 3000, 3):
        X[r, rng.integers(0, F, size=1 + r % 2)] = rng.choice([np.inf, -np.inf, np.nan])
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    x, prog = t(X), [t(a) for a in (A, B, C, D, V)]
    before = LAUNCHES["tree_gemm"]
    got = ops.tree_gemm_op(x, *prog, base=0.25)
    again = ops.tree_gemm_op(x, *prog, base=0.25)
    assert LAUNCHES["tree_gemm"] == before + 2
    xp = torch.nn.functional.pad(x, (0, A.shape[1] - F))
    want = ref.tree_gemm_ref(xp, *prog, 0.25)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert float((got[fin] - want[fin]).abs().max()) <= 1e-5
    assert np.array_equal(_bits(got), _bits(again))


def test_explicit_gemm_strategy_runs_trees_past_six_words(dev):
    """Trees of more than 192 internal nodes (depth 9: up to 285 here),
    compiled with ``strategy="gemm"``, run on the card's wide path: the
    program's scores are within 1e-5 of the same program's plain version on
    the CPU, in one kernel launch."""
    from repro_torch.data.datasets import make_hospital
    from repro_torch.ml import GradientBoostingClassifier, fit_pipeline
    from repro_torch.relational.table import to_device
    from repro_torch.tensor.compile import _max_internal, compile_pipeline_tensor

    train, infer = make_hospital(8000, seed=3), make_hospital(3000, seed=4)
    pipe = fit_pipeline(
        train.joined_columns(), train.label, train.numeric, train.categorical,
        GradientBoostingClassifier(n_estimators=4, max_depth=9),
        categories=train.categories(),
    )
    ens = next(n for n in pipe.nodes if n.op == "tree_ensemble").attrs["ensemble"]
    assert _max_internal(ens) > 192
    cols = infer.joined_columns()
    outs = []
    for d in ("cpu", dev):
        prog = compile_pipeline_tensor(pipe, strategy="gemm", device=d).fn
        before = LAUNCHES["tree_gemm"]
        out = prog({n: to_device(cols[n], d) for n in pipe.input_names()})
        outs.append({k: v.cpu() for k, v in out.items() if v.is_floating_point()})
    assert LAUNCHES["tree_gemm"] == before + 1 and outs[0]
    for k, want in outs[0].items():
        assert float((outs[1][k] - want).abs().max()) <= 1e-5, k


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _normal(rng, shape, dtype, dev):
    return torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B,Sq,Skv,KH,D", [
    (2, 128, 128, 2, 128),  # whole tiles
    (1, 100, 100, 1, 64),  # ragged, Sq == Skv
    (2, 37, 203, 2, 32),  # Sq < Skv: causal mask offset by Skv - Sq
    (3, 1, 77, 1, 16),  # one query row
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_vs_plain(dev, dtype, G, B, Sq, Skv, KH, D, causal):
    rng = np.random.default_rng(Sq * 1000 + Skv + G)
    q = _normal(rng, (B, Sq, KH * G, D), dtype, dev)
    k = _normal(rng, (B, Skv, KH, D), dtype, dev)
    v = _normal(rng, (B, Skv, KH, D), dtype, dev)
    before = LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(q, k, v, causal=causal)
    assert LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("B,S,KH,D", [(4, 1024, 2, 128), (3, 100, 1, 64), (5, 64, 2, 16)])
def test_decode_attention_kernel_vs_plain(dev, dtype, G, B, S, KH, D):
    """Lengths from 1 to S, and a cache longer than every length (whose rows
    past the lengths hold NaN: the kernel must never read them)."""
    rng = np.random.default_rng(S + G + B)
    q = _normal(rng, (B, KH * G, D), dtype, dev)
    k = _normal(rng, (B, S, KH, D), dtype, dev)
    v = _normal(rng, (B, S, KH, D), dtype, dev)
    for lengths in ([1] + [S] * (B - 1), rng.integers(1, S + 1, size=B),
                    rng.integers(1, S // 2 + 1, size=B)):
        lengths = torch.tensor(np.asarray(lengths), dtype=torch.int32, device=dev)
        kn, vn = k.clone(), v.clone()
        for b, n in enumerate(lengths.tolist()):
            kn[b, n:] = float("nan")
            vn[b, n:] = float("nan")
        before = LAUNCHES["decode_attention"]
        got = ops.decode_attention_op(q, kn, vn, lengths)
        assert LAUNCHES["decode_attention"] == before + 1
        want = ref.decode_attention_ref(q, k, v, lengths)
        assert got.dtype == dtype and got.shape == q.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= ATOL[dtype], err


def _attention_err(got, want, dtype):
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    return float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_at_the_serving_prefill(dev, dtype):
    """granite-3-8b's prefill of 16 prompts of 512 tokens (bf16 takes the
    tensor-core kernel, float32 the CUDA-core one; float32 at B = 2)."""
    B = 16 if dtype == torch.bfloat16 else 2
    rng = np.random.default_rng(16)
    q = _normal(rng, (B, 512, 32, 128), dtype, dev)
    k = _normal(rng, (B, 512, 8, 128), dtype, dev)
    v = _normal(rng, (B, 512, 8, 128), dtype, dev)
    before = LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(q, k, v, causal=True)
    assert LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=True)
    assert _attention_err(got, want, dtype) <= ATOL[dtype]


@pytest.mark.parametrize("D", [8, 24, 40, 128])
@pytest.mark.parametrize("Sq", [1, 37, 129, 203])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_kernel_pads_head_dims_and_ragged_rows(dev, D, Sq, causal):
    """Head dims that are a multiple of 8 but not of 16 are zero-padded in
    shared memory; Sq of 1, 37, 129 and 203 rows against Skv = 203 keys
    (none a whole tile), GQA 4."""
    rng = np.random.default_rng(D * 1000 + Sq)
    q = _normal(rng, (2, Sq, 8, D), torch.bfloat16, dev)
    k = _normal(rng, (2, 203, 2, D), torch.bfloat16, dev)
    v = _normal(rng, (2, 203, 2, D), torch.bfloat16, dev)
    got = ops.flash_attention_op(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert _attention_err(got, want, torch.bfloat16) <= 2e-2


def test_decode_attention_kernel_at_the_serving_tick(dev):
    """granite-3-8b's decode tick: 16 slots over a 1,024-row cache, lengths
    513..576, bf16; rows past the lengths hold NaN. The result repeats bit
    for bit."""
    rng = np.random.default_rng(1024)
    q = _normal(rng, (16, 32, 128), torch.bfloat16, dev)
    k = _normal(rng, (16, 1024, 8, 128), torch.bfloat16, dev)
    v = _normal(rng, (16, 1024, 8, 128), torch.bfloat16, dev)
    lengths = torch.tensor(rng.integers(513, 577, size=16), dtype=torch.int32, device=dev)
    kn, vn = k.clone(), v.clone()
    for b, n in enumerate(lengths.tolist()):
        kn[b, n:] = float("nan")
        vn[b, n:] = float("nan")
    got = ops.decode_attention_op(q, kn, vn, lengths)
    again = ops.decode_attention_op(q, kn, vn, lengths)
    want = ref.decode_attention_ref(q, k, v, lengths)
    assert _attention_err(got, want, torch.bfloat16) <= 2e-2
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KH,G", [(1, 1, 4), (1, 1, 16), (3, 2, 8)])
def test_decode_attention_kernel_at_chunk_edges(dev, dtype, B, KH, G):
    """Lengths of 1, chunk - 1, chunk, chunk + 1 and S rows for the split
    ``decode_splits`` makes (B * KH = 1: every split of one sequence), rows
    past the lengths NaN; each result within tolerance and repeated bit for
    bit by a second call."""
    from repro_torch.kernels.attention import decode_splits

    S, D = 1024, 128
    n_split, chunk = decode_splits(S, B, KH)
    assert n_split > 1
    rng = np.random.default_rng(B * 100 + G)
    q = _normal(rng, (B, KH * G, D), dtype, dev)
    k = _normal(rng, (B, S, KH, D), dtype, dev)
    v = _normal(rng, (B, S, KH, D), dtype, dev)
    for n in (1, chunk - 1, chunk, chunk + 1, S):
        lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
        kn, vn = k.clone(), v.clone()
        kn[:, n:] = float("nan")
        vn[:, n:] = float("nan")
        got = ops.decode_attention_op(q, kn, vn, lengths)
        want = ref.decode_attention_ref(q, k, v, lengths)
        assert _attention_err(got, want, dtype) <= ATOL[dtype], n
        assert torch.equal(got, ops.decode_attention_op(q, kn, vn, lengths)), n


def test_decode_attention_kernel_raises_on_an_empty_sequence(dev):
    """Also when the lengths were checked once and then changed in place
    (the check is skipped only for an unchanged tensor)."""
    q = torch.zeros((2, 4, 64), device=dev)
    k = torch.zeros((2, 16, 1, 64), device=dev)
    with pytest.raises(ValueError, match="lengths"):
        ops.decode_attention_op(q, k, k, torch.tensor([3, 0], device=dev))
    lengths = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    ops.decode_attention_op(q, k, k, lengths)
    lengths[1] = 0
    with pytest.raises(ValueError, match="lengths"):
        ops.decode_attention_op(q, k, k, lengths)
    lengths[1] = 17  # past the cache
    with pytest.raises(ValueError, match="lengths"):
        ops.decode_attention_op(q, k, k, lengths)


def test_attention_kernels_at_the_moe_serving_shapes(dev):
    """qwen2-moe-a2.7b's prefill (16 prompts of 512 tokens) and tick (16
    slots over a 1,024-row cache, lengths 513..576): H = KH = 16 (G = 1),
    D = 128, bf16, rows past the lengths NaN; the tick repeats bit for
    bit."""
    rng = np.random.default_rng(2048)
    q = _normal(rng, (16, 512, 16, 128), torch.bfloat16, dev)
    k = _normal(rng, (16, 512, 16, 128), torch.bfloat16, dev)
    v = _normal(rng, (16, 512, 16, 128), torch.bfloat16, dev)
    before = LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(q, k, v, causal=True)
    assert LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=True)
    assert _attention_err(got, want, torch.bfloat16) <= 2e-2
    q = _normal(rng, (16, 16, 128), torch.bfloat16, dev)
    k = _normal(rng, (16, 1024, 16, 128), torch.bfloat16, dev)
    v = _normal(rng, (16, 1024, 16, 128), torch.bfloat16, dev)
    lengths = torch.tensor(rng.integers(513, 577, size=16), dtype=torch.int32, device=dev)
    kn, vn = k.clone(), v.clone()
    for b, n in enumerate(lengths.tolist()):
        kn[b, n:] = float("nan")
        vn[b, n:] = float("nan")
    before = LAUNCHES["decode_attention"]
    got = ops.decode_attention_op(q, kn, vn, lengths)
    assert LAUNCHES["decode_attention"] == before + 1
    want = ref.decode_attention_ref(q, k, v, lengths)
    assert _attention_err(got, want, torch.bfloat16) <= 2e-2
    assert torch.equal(got, ops.decode_attention_op(q, kn, vn, lengths))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 112, 128])
@pytest.mark.parametrize("window", [1, 37, 64, 200, 300, 4096])
def test_flash_attention_kernel_with_a_window_vs_plain(dev, dtype, D, window):
    """The sliding window (query i keeps key j only if j > i + Skv - Sq -
    window) below and above S = 300 (ragged), causal and not, G = 1 and 4,
    and with Sq < Skv; a window of Skv or more runs as none, bit for bit."""
    rng = np.random.default_rng(window * 1000 + D)
    for causal, G, Sq in ((True, 1, 300), (True, 4, 300), (False, 1, 300), (True, 1, 77)):
        q = _normal(rng, (2, Sq, 2 * G, D), dtype, dev)
        k = _normal(rng, (2, 300, 2, D), dtype, dev)
        v = _normal(rng, (2, 300, 2, D), dtype, dev)
        before = LAUNCHES["flash_attention"]
        got = ops.flash_attention_op(q, k, v, causal=causal, window=window)
        assert LAUNCHES["flash_attention"] == before + 1
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        assert _attention_err(got, want, dtype) <= ATOL[dtype], (causal, G, Sq)
        if window >= 300:
            assert torch.equal(got, ops.flash_attention_op(q, k, v, causal=causal))


def test_flash_attention_kernel_window_at_zamba2s_long_prefill(dev):
    """zamba2-7b's shared attention over one 8,192-token prompt: H = KH = 32,
    D = 112, bf16, window 4,096, so the window masks half the keys."""
    rng = np.random.default_rng(8192)
    q, k, v = (_normal(rng, (1, 8192, 32, 112), torch.bfloat16, dev) for _ in range(3))
    got = ops.flash_attention_op(q, k, v, causal=True, window=4096)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=4096)
    assert _attention_err(got, want, torch.bfloat16) <= 2e-2
    assert not torch.equal(got, ops.flash_attention_op(q, k, v, causal=True))


def test_decode_attention_kernel_at_zamba2s_tick(dev):
    """zamba2-7b's decode over its ring buffer: 16 slots, 512 rows all
    valid, H = KH = 32 (G = 1), D = 112, bf16; the tick repeats bit for
    bit."""
    rng = np.random.default_rng(112)
    q = _normal(rng, (16, 32, 112), torch.bfloat16, dev)
    k = _normal(rng, (16, 512, 32, 112), torch.bfloat16, dev)
    v = _normal(rng, (16, 512, 32, 112), torch.bfloat16, dev)
    lengths = torch.full((16,), 512, dtype=torch.int32, device=dev)
    got = ops.decode_attention_op(q, k, v, lengths)
    want = ref.decode_attention_ref(q, k, v, lengths)
    assert _attention_err(got, want, torch.bfloat16) <= 2e-2
    assert torch.equal(got, ops.decode_attention_op(q, k, v, lengths))


@pytest.mark.parametrize("name", ["xlstm-350m", "zamba2-7b"])
def test_recurrent_prefill_and_decode_on_the_card_match_the_cpu(dev, name):
    """The reduced xlstm-350m and zamba2-7b in float32, zamba2 widened to
    head dim 112 (d_model 448, 4 heads, 14 SSM heads of 64), the same
    weights on both devices: prefill logits over 96 tokens (past the window
    of 64) and three decode steps' logits and caches within 1e-4 (float32
    sums in other orders), the attention kernels launched on the card."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    cfg = reduced_config(name)
    if name == "zamba2-7b":
        cfg = dataclasses.replace(cfg, d_model=448, n_heads=4, n_kv_heads=4, ssm_heads=14)
        assert cfg.hd == 112
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d) for k, v in tree.items()}

    rng = np.random.default_rng(3)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, size=(3, 99)), dtype=torch.int32)
    runs = []
    for p, d in ((params, "cpu"), (to(params, dev), dev)):
        before = dict(LAUNCHES)
        logits, caches = model.prefill(p, {"tokens": toks[:, :96].to(d)})
        out = [logits.cpu()]
        for t in range(96, 99):
            lengths = torch.full((3,), t, dtype=torch.int32, device=d)
            logits, caches = model.decode(p, {"tokens": toks[:, t].to(d), "lengths": lengths},
                                          caches)
            out.append(logits.cpu())
        runs.append((out, [c.cpu() for c in caches]))
        if d == dev and name == "zamba2-7b":
            assert LAUNCHES["flash_attention"] == before["flash_attention"] + 2
            assert LAUNCHES["decode_attention"] == before["decode_attention"] + 3 * 2
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert float((a.float() - b.float()).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 512, 512, 32, 8, 128), (2, 300, 300, 56, 8, 128),
                                   (2, 37, 203, 4, 2, 64), (2, 224, 1500, 12, 12, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_window_free_loop_keeps_the_bits(dev, dtype, shape, causal):
    """A call without a window runs the kernel compiled without the window's
    tests; the windowed kernel given a window past Skv masks nothing and
    must give the same bits (the window-free path's arithmetic is the
    loop's, only its tests are gone)."""
    from repro_torch.kernels import _build

    B, Sq, Skv, H, KH, D = shape
    if causal and Sq > Skv:
        return
    rng = np.random.default_rng(Sq + Skv + H)
    q = _normal(rng, (B, Sq, H, D), dtype, dev)
    k = _normal(rng, (B, Skv, KH, D), dtype, dev)
    v = _normal(rng, (B, Skv, KH, D), dtype, dev)
    free = ops.flash_attention_op(q, k, v, causal=causal)
    wide = torch.empty_like(q)
    entry = getattr(_build.lib(), "raven_flash_attention_bf16" if dtype == torch.bfloat16
                    else "raven_flash_attention_f32")
    _build.check("flash_attention", entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), wide.data_ptr(), B, Sq, Skv, H, KH, D,
        1.0 / D ** 0.5, int(causal), Skv + 64, _build.stream_ptr(dev)))
    assert torch.equal(free, wide)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Skv", [(2, 200, 200), (1, 1088, 1088), (2, 37, 203)])
def test_flash_attention_kernel_at_g7(dev, dtype, causal, B, Sq, Skv):
    """llava-next-34b's heads: H = 56 over KH = 8 (G = 7, an odd count of
    query heads a KV head), D = 128; its prefill of 576 patch rows and 512
    tokens (1,088), a ragged square and Sq < Skv."""
    rng = np.random.default_rng(Sq + Skv + causal)
    q = _normal(rng, (B, Sq, 56, 128), dtype, dev)
    k = _normal(rng, (B, Skv, 8, 128), dtype, dev)
    v = _normal(rng, (B, Skv, 8, 128), dtype, dev)
    got = ops.flash_attention_op(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert _attention_err(got, want, dtype) <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq", [(16, 1500), (16, 4), (16, 224), (2, 1500)])
def test_flash_attention_kernel_at_whispers_sites(dev, dtype, B, Sq):
    """whisper-small's non-causal attention at D = 64, H = KH = 12, over the
    1,500 encoder rows (no multiple of a tile: the last K/V tile is ragged):
    the encoder (1,500 queries) and the cross attention of a 4- and a
    224-token prompt. float32 at B = 2 and 16."""
    if dtype == torch.float32 and Sq == 1500 and B == 16:
        B = 4
    rng = np.random.default_rng(Sq + B)
    q = _normal(rng, (B, Sq, 12, 64), dtype, dev)
    k = _normal(rng, (B, 1500, 12, 64), dtype, dev)
    v = _normal(rng, (B, 1500, 12, 64), dtype, dev)
    before = LAUNCHES["flash_attention"]
    got = ops.flash_attention_op(q, k, v, causal=False)
    assert LAUNCHES["flash_attention"] == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=False)
    assert _attention_err(got, want, dtype) <= ATOL[dtype]
    assert torch.equal(got, ops.flash_attention_op(q, k, v, causal=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_at_g7(dev, dtype):
    """llava-next-34b's decode: 8 sequences over a 1,124-row cache, H = 56
    over KH = 8 (G = 7 rows of the tensor-core kernel's m16 fragment),
    D = 128; lengths ragged, full and of one row, with NaN past each
    length."""
    rng = np.random.default_rng(7)
    B, S = 8, 1124
    q = _normal(rng, (B, 56, 128), dtype, dev)
    k = _normal(rng, (B, S, 8, 128), dtype, dev)
    v = _normal(rng, (B, S, 8, 128), dtype, dev)
    for lengths in ([1089, 1100, 1120, 1124, 1, 64, 65, 700], [S] * B):
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kn, vn = k.clone(), v.clone()
        for b, n in enumerate(lengths.tolist()):
            kn[b, n:] = float("nan")
            vn[b, n:] = float("nan")
        got = ops.decode_attention_op(q, kn, vn, lengths)
        want = ref.decode_attention_ref(q, k, v, lengths)
        assert _attention_err(got, want, dtype) <= ATOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("full", [True, False], ids=["every-length-1500", "ragged"])
def test_decode_attention_kernel_over_whispers_cross_cache(dev, dtype, full):
    """whisper-small's cross attention in decode: 16 clips over their 1,500
    encoder rows, H = KH = 12 (G = 1), D = 64. ``decode_splits`` cuts the
    cache into chunks of whole 64-row tiles, so the last split is ragged;
    the call repeats bit for bit."""
    from repro_torch.kernels.attention import SPLIT_TILE, decode_splits

    n_split, chunk = decode_splits(1500, 16, 12)
    assert chunk % SPLIT_TILE == 0 and n_split * chunk >= 1500 and 1500 % chunk
    rng = np.random.default_rng(1500 + full)
    q = _normal(rng, (16, 12, 64), dtype, dev)
    k = _normal(rng, (16, 1500, 12, 64), dtype, dev)
    v = _normal(rng, (16, 1500, 12, 64), dtype, dev)
    lengths = np.full(16, 1500) if full else rng.integers(1, 1501, size=16)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    got = ops.decode_attention_op(q, k, v, lengths)
    want = ref.decode_attention_ref(q, k, v, lengths)
    assert _attention_err(got, want, dtype) <= ATOL[dtype]
    assert torch.equal(got, ops.decode_attention_op(q, k, v, lengths))


def _to(tree, d):
    return {k: _to(v, d) if isinstance(v, dict) else v.to(d) for k, v in tree.items()}


def _family_batch(cfg, B: int, S: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    key = "patches" if cfg.family == "vlm" else "frames"
    return {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, size=(B, S)),
                                   dtype=torch.int32),
            key: torch.tensor(rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)) * 0.5,
                              dtype=torch.float32)}


def _prefill_and_decode(model, params, batch, d, steps: int):
    """The prefill (caches with ``steps`` rows of room) and ``steps`` greedy
    decode steps on device ``d``: every step's logits and the last caches,
    on the CPU."""
    rows = batch["tokens"].shape[1] + (model.cfg.frontend_tokens
                                       if model.cfg.family == "vlm" else 0)
    logits, caches = model.prefill(params, {k: v.to(d) for k, v in batch.items()},
                                   cache_len=rows + steps)
    out = [logits.cpu()]
    for t in range(steps):
        lengths = torch.full((logits.shape[0],), rows + t, dtype=torch.int32, device=d)
        logits, caches = model.decode(params, {"tokens": logits.argmax(-1).to(torch.int32),
                                               "lengths": lengths}, caches)
        out.append(logits.cpu())
    return out, [c.cpu() for c in caches]


@pytest.mark.parametrize("name", ["llava-next-34b", "whisper-small"])
def test_reduced_vlm_and_encdec_on_the_card_match_the_cpu(dev, name):
    """The reduced llava-next-34b and whisper-small in float32, the same
    weights on both devices: prefill and three greedy decode steps' logits
    and every cache within 1e-4 (float32 sums in other orders), the
    attention kernels launched on the card (whisper: the encoder's, the
    decoder's self and cross attention)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    cfg = reduced_config(name)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _family_batch(cfg, 3, 20, seed=5)
    want = _prefill_and_decode(model, params, batch, "cpu", 3)
    before = dict(LAUNCHES)
    got = _prefill_and_decode(model, _to(params, dev), batch, dev, 3)
    flash = cfg.n_layers + (cfg.encoder_layers + cfg.n_layers if name == "whisper-small" else 0)
    decode = 3 * cfg.n_layers * (2 if name == "whisper-small" else 1)
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + flash
    assert LAUNCHES["decode_attention"] == before["decode_attention"] + decode
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert float((a.float() - b.float()).abs().max()) <= 1e-4


@pytest.mark.parametrize("name,n_layers", [("llava-next-34b", 2), ("whisper-small", 12)])
def test_full_width_vlm_and_encdec_on_the_kernels_match_plain_attention(dev, name, n_layers,
                                                                        monkeypatch):
    """At the published widths in float32 (llava-next-34b cut to 2 of its
    60 layers: d_model 7,168, H = 56 over KH = 8, 576 patch rows; whisper-
    small whole: 12 + 12 layers, D = 64, 1,500 frames), the prefill and
    three greedy decode steps on the hand-written kernels and on the plain
    attention: every logit within 1e-3 of the largest, the same tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(name), n_layers=n_layers, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = _family_batch(cfg, 2, 64 if name == "llava-next-34b" else 4, seed=6)
    got = _prefill_and_decode(model, params, batch, dev, 3)[0]
    monkeypatch.setattr(ops, "_route", lambda t, op: False)  # the plain versions
    before = dict(LAUNCHES)
    want = _prefill_and_decode(model, params, batch, dev, 3)[0]
    assert LAUNCHES == before
    V = cfg.vocab_size
    for a, b in zip(got, want):
        a, b = a[:, :V], b[:, :V]
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
        assert torch.equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "arctic-480b"])
def test_moe_ffn_on_the_card_matches_its_cpu_run(dev, name, dispatch):
    """The reduced configs in float32 (TF32 off), several token blocks and a
    decode tick's shape, a skewed router that drops assignments: within
    rtol 1e-5, atol 1e-6 of the CPU run on the same weights, with the same
    routing and drops; the decode shape also captured into a CUDA graph, whose replay
    equals its eager run bitwise."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.exec import capture
    from repro_torch.models.moe import moe_ffn, moe_param_shapes, route

    cfg = dataclasses.replace(reduced_config(name), moe_dispatch=dispatch)
    rng = np.random.default_rng(7)
    p = {k: torch.tensor(rng.normal(size=shape) * (0.5 if k == "router_col"
                                                   else 1 / np.sqrt(shape[-2])),
                         dtype=torch.float32)
         for k, shape in moe_param_shapes(cfg).items()}
    p["router_col"][0, 0] = 40.0  # the first expert wins most tokens
    pd = {k: v.to(dev) for k, v in p.items()}
    drops = []
    for shape, block in (((2, 40), 16), ((16, 1), 4096)):
        x = torch.tensor(rng.normal(size=(*shape, cfg.d_model)), dtype=torch.float32)
        x[..., 0] = 3.0
        want = moe_ffn(p, x, cfg, token_block=block)
        got = moe_ffn(pd, x.to(dev), cfg, token_block=block)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
        experts, kept = route(p, x, cfg, token_block=block)
        on_card = route(pd, x.to(dev), cfg, token_block=block)
        assert torch.equal(on_card[0].cpu(), experts) and torch.equal(on_card[1].cpu(), kept)
        drops.append(int((~kept).sum()))
    assert drops[0] > 0
    xd = x.to(dev)
    graph, out, _, _ = capture.record(lambda: moe_ffn(pd, xd, cfg), dev)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, moe_ffn(pd, xd, cfg))


def test_the_analysis_gate_passes_on_the_card(dev, capsys):
    """``python -m repro_torch.analysis`` on the card (its default device):
    exit 0, every scenario verified, and the relational kernels launched by
    the scenarios."""
    from repro_torch.analysis.__main__ import main

    before = dict(LAUNCHES)
    assert main(["--device", "cuda"]) == 0
    out = capsys.readouterr().out
    assert out.count("ok: scenario") == 8 and "faultdrill scenario" in out
    assert LAUNCHES["gather_join"] > before["gather_join"]
    assert LAUNCHES["segment_agg"] > before["segment_agg"]


def test_reduced_granite_serves_the_same_tokens_on_the_card_and_the_cpu(dev):
    """The reduced granite-3-8b config in float32, the same weights on both
    devices: greedy serving gives identical tokens (float32 attention on the
    card's kernels, plain versions on the CPU)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = reduced_config("granite-3-8b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d) for k, v in tree.items()}

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 32, 17, 9, 40)]
    outs = []
    for p, d in ((params, "cpu"), (to(params, dev), dev)):
        eng = ServeEngine(model, p, n_slots=2, cache_len=64, device=d)
        for i, pr in enumerate(prompts):
            eng.submit(pr, max_new_tokens=4 + i)
        before = dict(LAUNCHES)
        outs.append([r.output for r in sorted(eng.run(max_ticks=200), key=lambda r: r.rid)])
        if d == dev:
            assert LAUNCHES["flash_attention"] > before["flash_attention"]
            assert LAUNCHES["decode_attention"] > before["decode_attention"]
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# The host ML runtime (split MLtoDNN, transform="none") and MLtoSQL
# ---------------------------------------------------------------------------


def _split_udf(X):
    return (X.astype(np.float32) * np.float32(0.5)) + np.float32(0.25)


_split_udf.__fingerprint_token__ = "test-torch-cuda-split-udf-v1"


def _hospital_on_both(split: bool):
    """A small hospital model (and, with ``split``, its form with a
    python_udf over the feature block before the model), its inference
    rows and a binding of ``:t`` mid-way in a wide gap between host scores."""
    import dataclasses

    from repro_torch.data.datasets import make_hospital
    from repro_torch.ml import GradientBoostingClassifier, fit_pipeline, run_pipeline
    from repro_torch.ml.pipeline import PipelineNode

    train, infer = make_hospital(1024, seed=0), make_hospital(5000, seed=0)
    pipe = fit_pipeline(
        train.joined_columns(), train.label, train.numeric, train.categorical,
        GradientBoostingClassifier(n_estimators=10, max_depth=3),
        categories=train.categories(),
    )
    if split:
        nodes = list(pipe.nodes)
        mi = next(i for i, nd in enumerate(nodes) if nd.op == "tree_ensemble")
        udf = PipelineNode("python_udf", [nodes[mi].inputs[0]], ["features_h"],
                           {"fn": _split_udf})
        model = dataclasses.replace(nodes[mi], inputs=["features_h"])
        pipe = dataclasses.replace(pipe, nodes=[*nodes[:mi], udf, model, *nodes[mi + 1:]])
    cols = infer.joined_columns()
    s = np.unique(run_pipeline(pipe, {n: cols[n] for n in pipe.input_names()})["score"])
    i = len(s) // 2 + int(np.argmax(np.diff(s[len(s) // 2:][:1001])))
    assert s[i + 1] - s[i] >= 2e-5
    return pipe, infer, float((s[i] + s[i + 1]) / 2)


@pytest.mark.parametrize("transform,split", [("dnn", True), ("none", False), ("sql", False)])
def test_host_runtime_and_mltosql_on_the_card_match_the_cpu(dev, transform, split):
    """The split plan (featurize before the host boundary, tree_gemm and
    segment_agg after it), the interpreter behind one MLUdf and MLtoSQL's
    CASE expressions, run on the card and on the CPU from one compiled
    plan: COUNT equal, AVG within rtol 1e-5; no cut column in the result.
    The launches counted are a warm run's (its graphs captured by the first
    run): one of each kernel the plan reaches."""
    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
    from repro_torch.relational.engine import compile_plan
    from repro_torch.sql.parser import parse_prediction_query

    pipe, infer, t = _hospital_on_both(split)
    sql = ("SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) "
           "AS p WHERE score >= :t")
    q = parse_prediction_query(sql, {"m": pipe}, infer.tables)
    plan, _ = RavenOptimizer(options=OptimizerOptions(transform=transform)).optimize(q)
    cp = compile_plan(plan)
    want_kinds = {"dnn": ["pure", "host", "pure"], "none": ["pure", "host", "pure"],
                  "sql": ["pure"]}[transform]
    assert [s.kind for s in cp.stages] == want_kinds
    from repro_torch.relational.engine import upload_database

    db = upload_database(infer.tables, dev)
    cp.run(db, params={"t": t})
    before = dict(LAUNCHES)
    got = cp.run(db, params={"t": t}).table
    assert got.valid.is_cuda
    got = got.to_numpy()
    ran = {k: LAUNCHES[k] - before[k] for k in ("featurize", "tree_gemm", "segment_agg")}
    model = 1 if transform == "dnn" else 0
    assert ran == {"featurize": model, "tree_gemm": model, "segment_agg": 1}
    want = cp.run(infer.tables, params={"t": t}, device="cpu").table.to_numpy()
    assert sorted(got) == sorted(want) == ["count_rows", "mean_score"]
    assert got["count_rows"][0] > 0
    assert np.array_equal(got["count_rows"], want["count_rows"])
    np.testing.assert_allclose(got["mean_score"], want["mean_score"], rtol=1e-5)


@pytest.mark.parametrize("udf_pos", ["start", "middle", "end"])
def test_split_execution_on_the_card_matches_host_bitwise(dev, udf_pos):
    """A scaler pipeline cut around a python_udf, run on the card through
    the engine, on inputs with subnormals and signed zeros: bitwise the
    host interpreter's (CUDA's elementwise kernels flush no subnormal)."""
    from repro_torch.core.ir import LPredict, LScan, PredictionQuery
    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
    from repro_torch.ml.pipeline import InputSpec, PipelineNode, TrainedPipeline, run_pipeline
    from repro_torch.relational.engine import compile_plan

    special = np.array([0.0, -0.0, 1e-45, -1e-45, 9.5e-43, -3e-39, 1.0, -1e3], np.float32)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1e3, 1e3, 4099).astype(np.float32)
    x[::3] = rng.choice(special, size=x[::3].size)
    # x = 9.5e-43 gives -0.0, x = 0 a subnormal 9.5e-43
    off, sc = np.array([9.5e-43], np.float32), np.array([-1.0], np.float32)
    nodes = [PipelineNode("concat", ["x0"], ["raw"]),
             PipelineNode("scaler", ["raw"], ["scaled"], {"offset": off, "scale": sc}),
             PipelineNode("feature_extractor", ["scaled"], ["feat"], {"indices": [0]})]
    where = {"start": 0, "middle": 2, "end": 3}[udf_pos]
    src = ["x0", "raw", "scaled", "feat"][where]
    nodes.insert(where, PipelineNode("python_udf", [src], [src + "_h"], {"fn": _split_udf}))
    for nd in nodes[where + 1:]:
        nd.inputs = [src + "_h" if v == src else v for v in nd.inputs]
    final = nodes[-1].outputs[0]
    pipe = TrainedPipeline(inputs=[InputSpec("x0", "numeric")], outputs=[final], nodes=nodes)
    q = PredictionQuery(plan=LPredict(LScan("t", ["x0"]), pipe, [final]))
    plan, _ = RavenOptimizer(options=OptimizerOptions(
        transform="dnn", projection_pushdown=False)).optimize(q)
    out = compile_plan(plan).run({"t": {"x0": x}}).table.to_numpy()
    want = np.asarray(run_pipeline(pipe, {"x0": x})[final], np.float32).reshape(-1)
    got = np.asarray(out[final], np.float32).reshape(-1)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# Capture: pure stages and the decode tick as CUDA graphs; the query server
# ---------------------------------------------------------------------------

HOSPITAL_AGG = ("SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) "
                "AS p WHERE score >= :t")


def _hospital_session(dev, split: bool):
    import repro_torch as raven

    pipe, infer, t = _hospital_on_both(split)
    db = raven.connect(infer.tables, device=dev)
    db.register_model("m", pipe)
    return db, t


def _assert_bitwise(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(_bits(torch.from_numpy(np.asarray(got[k]))),
                              _bits(torch.from_numpy(np.asarray(want[k])))), k


@pytest.mark.parametrize("transform,split", [("dnn", False), ("dnn", True),
                                             ("none", False), ("sql", False)])
def test_captured_hospital_plans_equal_eager_bitwise(dev, transform, split):
    """The hospital query through the front door, captured (one graph a
    pure stage) and eager (``capture.disabled()``): bitwise equal results;
    a second call of the same shapes captures nothing and replays."""
    from repro_torch.exec import capture
    from repro_torch.relational.engine import PLAN_CACHE_STATS, clear_plan_cache

    clear_plan_cache()  # a plan of its own: no graph of another test's
    db, t = _hospital_session(dev, split)
    prep = db.sql(HOSPITAL_AGG).prepare(transform=transform, params={"t": t})
    pure = sum(st.kind == "pure" for st in prep.compiled.stages)
    captured = prep()
    assert prep.compiled.traces == pure
    replays = PLAN_CACHE_STATS.replays
    again = prep.bind(t=t)()
    assert prep.compiled.traces == pure and PLAN_CACHE_STATS.replays == replays + pure
    with capture.disabled():
        eager = prep()
    assert captured["count_rows"][0] > 0
    _assert_bitwise(captured, eager)
    _assert_bitwise(again, eager)


@pytest.mark.parametrize("segmented", [False, True])
def test_captured_dashboard_plan_equals_eager_bitwise(dev, segmented):
    """Filter→join→aggregate over an uploaded star schema (gather_join and
    segment_agg in one graph), global and in 6 segments: captured equals
    eager bitwise, once captured and then replayed."""
    from repro_torch.exec import capture
    from repro_torch.relational import engine as teng
    from repro_torch.relational.expr import Bin, Col, Const

    rng = np.random.default_rng(6)
    tables = {"d": {"k": np.arange(4096, dtype=np.int64), "v": _dyadic(rng, 4096)},
              "f": {"fk": rng.integers(0, 5000, 200_000).astype(np.int64),
                    "x": _dyadic(rng, 200_000)}}
    plan = teng.Aggregate(
        teng.Filter(teng.Join(teng.Scan("f", ["fk", "x"]), "d", "fk", "k", ["v"]),
                    Bin("gt", Col("x"), Const(0.0))),
        [("n", "count", "x"), ("s", "sum", "v"), ("a", "mean", "x"),
         ("lo", "min", "v"), ("hi", "max", "x")])
    seg = np.sort(rng.integers(0, 6, 200_000)).astype(np.int32)
    segments = (seg, 6) if segmented else None
    db = teng.upload_database(tables, dev)
    cp = teng.compile_plan(plan, cache=False)
    runs = [cp.run(db, segments=segments).table.to_numpy() for _ in range(2)]
    assert cp.traces == 1
    with capture.disabled():
        eager = cp.run(db, segments=segments).table.to_numpy()
    for got in runs:
        _assert_bitwise(got, eager)


def test_segment_agg_in_a_captured_stage_replays_50_times_bitwise(dev):
    """A segmented aggregate stage, captured once and replayed 50 times on
    two alternating sets of segment ids (copied into the graph's buffer
    each replay): every result bitwise the eager run's; the kernel's fold
    counter resets itself at every replay."""
    from repro_torch.exec import capture
    from repro_torch.relational import engine as teng
    from repro_torch.relational.engine import PLAN_CACHE_STATS

    rng = np.random.default_rng(9)
    n = 300_000
    tables = {"f": {"x": _dyadic(rng, n), "y": _dyadic(rng, n)}}
    plan = teng.Aggregate(teng.Scan("f", ["x", "y"]),
                          [("n", "count", "x"), ("s", "sum", "x"), ("m", "max", "y")])
    segs = [(rng.integers(0, 8, n).astype(np.int32), 8) for _ in range(2)]
    db = teng.upload_database(tables, dev)
    cp = teng.compile_plan(plan, cache=False)
    with capture.disabled():
        want = [cp.run(db, segments=s).table.to_numpy() for s in segs]
    cp.run(db, segments=segs[0])
    copies = PLAN_CACHE_STATS.capture_input_copies
    for i in range(50):
        _assert_bitwise(cp.run(db, segments=segs[i % 2]).table.to_numpy(), want[i % 2])
    assert cp.traces == 1
    assert PLAN_CACHE_STATS.capture_input_copies > copies


def test_captured_decode_tick_serves_the_eager_tokens(dev):
    """Reduced granite-3-8b served with the decode tick captured (one graph
    for the engine, replayed every tick) and eagerly: the same tokens."""
    from repro_torch.configs import reduced_config
    from repro_torch.exec import capture
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = reduced_config("granite-3-8b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (5, 32, 17, 9, 40)]

    def serve():
        eng = ServeEngine(model, params, n_slots=2, cache_len=64, device=dev)
        for i, pr in enumerate(prompts):
            eng.submit(pr, max_new_tokens=4 + i)
        return eng, [r.output for r in sorted(eng.run(max_ticks=200), key=lambda r: r.rid)]

    eng, captured = serve()
    assert eng.captures == 1 and eng.replays > 1
    with capture.disabled():
        eager_eng, eager = serve()
    assert eager_eng.captures == 0 and captured == eager


def test_served_hospital_query_equals_one_shot_and_warm_buckets_capture_nothing(dev):
    """``prep.serve()`` → ``submit`` → ``flush`` on the card: each request's
    answer equals the same prepared query's one-shot call on its batch
    (COUNT equal, AVG within rtol 1e-5: padding changes the order of the
    kernel's sums); a second pass over the same buckets captures nothing."""
    from repro_torch.data.datasets import make_hospital

    db, t = _hospital_session(dev, False)
    prep = db.sql(HOSPITAL_AGG).prepare(transform="dnn", params={"t": t}).serve()
    batches = [make_hospital(n, seed=10 + i).tables["patients"]
               for i, n in enumerate((1, 37, 64, 65, 300, 1000))]
    reqs = [prep.submit(b) for b in batches]
    db.flush()
    assert db.server.recompiles() >= 1
    for r, b in zip(reqs, batches):
        want = prep(b)  # one-shot: exact shapes, graphs of their own
        assert np.array_equal(r.result["count_rows"], want["count_rows"])
        np.testing.assert_allclose(r.result["mean_score"], want["mean_score"], rtol=1e-5)
    recompiles = db.server.recompiles()
    again = [prep.submit(b) for b in batches]
    db.flush()
    assert db.server.recompiles() == recompiles
    for r, first in zip(again, reqs):
        _assert_bitwise(r.result, first.result)
    db.close()


@pytest.mark.parametrize("transform,split", [("none", False), ("dnn", True)])
def test_served_host_boundary_plans_equal_one_shot(dev, transform, split):
    """Plans with a host boundary served on the card through the pipelined
    executor: the boundary runs on a pool thread after an event behind its
    upstream graph, the coalesced group is split on segment ids; each
    answer equals the one-shot call on its batch (COUNT equal, AVG within
    rtol 1e-5), flushed and with the pump on."""
    from repro_torch.data.datasets import make_hospital
    from repro_torch.exec import capture

    db, t = _hospital_session(dev, split)
    prep = db.sql(HOSPITAL_AGG).prepare(transform=transform, params={"t": t}).serve()
    batches = [make_hospital(n, seed=30 + i).tables["patients"]
               for i, n in enumerate((1, 200, 700, 64))]
    with capture.disabled():
        wants = [prep(b) for b in batches]
    for pump in (False, True):
        if pump:
            db.server.start_pump(5.0)
        reqs = [prep.submit(b) for b in batches]
        if pump:
            outs = [r.wait(timeout=60.0) for r in reqs]
            db.server.stop_pump()
        else:
            db.flush()
            outs = [r.result for r in reqs]
        for out, want in zip(outs, wants):
            assert np.array_equal(out["count_rows"], want["count_rows"])
            np.testing.assert_allclose(out["mean_score"], want["mean_score"], rtol=1e-5)
    assert db.server.stats.segmented_batches >= 1
    db.close()


def _capture_raises(dev, call):
    from repro_torch.device import CaptureError

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            with pytest.raises(CaptureError):
                call()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)


def test_lazy_caches_and_host_reads_raise_while_capturing(dev):
    """Inside a capture, reaching what the eager warm-up must build (an
    expression's constant, featurize's ``val_col``, a tree program's
    packing, a join's sorted payload) or a read back to the host
    (decode_attention's check of the lengths) raises; nothing is copied
    from host memory into the graph."""
    from repro_torch.relational.engine import Join, Scan, dimsort_entry
    from repro_torch.relational.expr import Bin, Col, Const, eval_expr
    from repro_torch.tensor.compile import emit_join_kernel

    x = torch.arange(16, dtype=torch.float32, device=dev)
    _capture_raises(dev, lambda: eval_expr(Bin("gt", Col("x"), Const(3.0)), {"x": x},
                                           consts={}))
    rng = np.random.default_rng(2)
    args = _featurize_columns(rng, 1000, 3, (2, 3), dev)
    _capture_raises(dev, lambda: ops.featurize_op(*args))
    A, B, C, D, V = (torch.tensor(a, device=dev) for a in ops.pad_gemm_program(
        *_full_tree_program(2, 3, 5, rng)))
    xt = torch.zeros((10, 5), device=dev)
    _capture_raises(dev, lambda: ops.tree_gemm_op(xt, A, B, C, D, V, base=0.0))
    q = torch.zeros((2, 4, 64), device=dev)
    kc = torch.zeros((2, 16, 1, 64), device=dev)
    lengths = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    _capture_raises(dev, lambda: ops.decode_attention_op(q, kc, kc, lengths))
    dim = {"k": torch.arange(8, dtype=torch.int32, device=dev),
           "v": torch.ones(8, device=dev)}
    ds = dimsort_entry(np.arange(8, dtype=np.int32), dev)
    join = Join(Scan("f", ["fk"]), "d", "fk", "k", ["v"])
    fk = torch.arange(4, dtype=torch.int32, device=dev)
    _capture_raises(dev, lambda: emit_join_kernel(join, dim, fk, ds))


def test_kernels_launch_on_the_capturing_stream(dev):
    """The ctypes launches take PyTorch's current stream: inside a capture,
    the capturing stream."""
    from repro_torch.kernels import _build

    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            ptr = _build.stream_ptr(dev)
        finally:
            graph.capture_end()
    assert ptr == side.cuda_stream


# ---------------------------------------------------------------------------
# Runtime selection and plan verification on the card
# ---------------------------------------------------------------------------


def test_corpus_measured_on_the_card(dev):
    """Three pipelines of seed 1 measured on the card: every runtime's time
    is finite (MLtoSQL takes these pipelines), the labels are the argmin and
    the statistics are the pipelines' own."""
    from repro_torch.core.corpus import build_corpus
    from repro_torch.core.stats import pipeline_stats

    corpus = build_corpus(n_pipelines=3, n_rows=2048, seed=1, device=dev)
    assert corpus.stats.shape == (3, 22) and corpus.runtimes.shape == (3, 3)
    assert np.isfinite(corpus.runtimes).all() and (corpus.runtimes > 0).all()
    assert np.array_equal(corpus.labels, np.argmin(corpus.runtimes, axis=1))
    assert np.array_equal(corpus.stats, np.stack([pipeline_stats(p) for p in corpus.pipelines]))


def test_corpus_pushes_no_graph_out_of_the_capture_cache(dev, monkeypatch):
    """A corpus measures twice as many plans as the capture cache has room
    for, and leaves a query prepared before it as it was: its graphs stay
    (no eviction, no capture on its next call) and nothing of the corpus is
    held after it."""
    from repro_torch.core.corpus import build_corpus
    from repro_torch.exec import capture

    db, t = _hospital_session(dev, False)
    prep = db.sql(HOSPITAL_AGG).prepare(transform="dnn", params={"t": t})
    want = prep()
    traces, held, evicted = prep.compiled.traces, capture.held()[0], capture.evictions()
    monkeypatch.setattr(capture, "GRAPH_CAPACITY", held + 3)
    build_corpus(n_pipelines=3, n_rows=2048, seed=1, device=dev)
    assert capture.evictions() == evicted
    assert capture.held()[0] <= held
    got = prep()
    assert prep.compiled.traces == traces
    assert np.array_equal(got["count_rows"], want["count_rows"])


def test_verify_plan_of_a_fresh_optimizer_plan_runs_on_the_card(dev):
    """A plan straight from the optimizer (its tensor programs built on the
    CPU) verified against a card database: the abstract run moves the
    programs to the card and launches the kernels there; asking for another
    device than the database's is refused."""
    from repro_torch.analysis import verifier
    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
    from repro_torch.exec.stages import build_stage_graph
    from repro_torch.relational.engine import TensorOp, walk_plan

    db, t = _hospital_session(dev, False)
    plan, _ = RavenOptimizer(options=OptimizerOptions(transform="dnn")).optimize(
        db.sql(HOSPITAL_AGG).ir)
    programs = [p.fn for p in walk_plan(plan) if isinstance(p, TensorOp)]
    assert programs and all(next(m.buffers()).device.type == "cpu" for m in programs)
    verifier._EXEC_MEMO.clear()
    before = {n: LAUNCHES[n] for n in ("featurize", "tree_gemm", "segment_agg")}
    assert verifier.verify_plan(plan, db.database, mode="strict") == ["plan: ok"]
    assert all(LAUNCHES[n] > k for n, k in before.items()), (before, dict(LAUNCHES))
    assert all(next(m.buffers()).device == db.database.device for m in programs)
    with pytest.raises(ValueError, match="lies on"):
        verifier.check_exec(build_stage_graph(plan), db.database, device="cpu")


@pytest.mark.parametrize("transform,split", [("dnn", False), ("dnn", True),
                                             ("sql", False), ("none", False)])
def test_strict_verification_on_the_card(dev, transform, split):
    """Every lowering of the hospital query verifies clean under
    ``verify="strict"`` on the card (its abstract runs launch the kernels
    there), answers as on the CPU, and a phantom output column is refused."""
    from repro_torch.analysis import verifier
    from repro_torch.errors import PlanVerificationError
    from repro_torch.exec.stages import build_stage_graph

    db, t = _hospital_session(dev, split)
    verifier._EXEC_MEMO.clear()
    before = LAUNCHES["segment_agg"]
    prep = db.sql(HOSPITAL_AGG).prepare(transform=transform, params={"t": t}, verify="strict")
    assert LAUNCHES["segment_agg"] > before  # the abstract runs, on the card
    assert prep.report.verification[-1] == "prepare (stage graph): ok"
    assert all(line.endswith(": ok") for line in prep.report.verification)
    got = prep()
    cpu, _ = _hospital_session("cpu", split)
    want = cpu.sql(HOSPITAL_AGG).prepare(transform=transform, params={"t": t})()
    assert np.array_equal(got["count_rows"], want["count_rows"])
    np.testing.assert_allclose(got["mean_score"], want["mean_score"], rtol=1e-5)
    graph = build_stage_graph(prep.compiled.graph.plan)
    graph.stages[-1].out_columns += ("phantom",)
    with pytest.raises(PlanVerificationError) as ei:
        verifier.verify_graph(graph, db.database, mode="strict")
    assert "schema-chain" in {v.rule for v in ei.value.violations}


# ---------------------------------------------------------------------------
# Persistence and lifecycle on the card
# ---------------------------------------------------------------------------

LIFECYCLE_SIZES = (100, 1000, 3000)  # three row buckets: 128, 1024, 4096


def _lifecycle_session(dev, cache_dir=None):
    import repro_torch as raven

    pipe, infer, t = _hospital_on_both(False)
    db = raven.connect(infer.tables, device=dev,
                       options=raven.ConnectOptions(cache_dir=cache_dir))
    db.models.publish("m", pipe)
    prep = db.sql(HOSPITAL_AGG).prepare(transform="dnn", params={"t": t})
    return db, prep.serve("q")


def _ladder(db, prep) -> list:
    from repro_torch.data.datasets import make_hospital

    outs = []
    for i, n in enumerate(LIFECYCLE_SIZES):
        req = prep.submit(make_hospital(n, seed=30 + i).tables["patients"])
        db.flush()
        outs.append((req.served_by, req.wait(timeout=60.0)))
    return outs


def test_warm_start_captures_from_the_store_before_the_first_request(dev, tmp_path):
    """A session serves three buckets with ``cache_dir``; with the plan
    cache cleared (a fresh process's state) a second session's
    registration captures each stored bucket's graph, its requests capture
    nothing and count no trace, and its answers equal the first's bitwise."""
    from repro_torch.exec import capture
    from repro_torch.relational import engine

    cache = str(tmp_path / "cache")
    db, prep = _lifecycle_session(dev, cache)
    cold = _ladder(db, prep)
    db.close()  # drains the store's writer
    engine.clear_plan_cache()

    captures = capture.captures()
    db, prep = _lifecycle_session(dev, cache)
    stats = db.cache_stats()
    assert stats["server"]["warm_started_buckets"] == len(LIFECYCLE_SIZES)
    assert stats["disk_hits"] >= len(LIFECYCLE_SIZES)
    assert capture.captures() - captures == len(LIFECYCLE_SIZES)  # at registration
    assert stats["traces"] == 0 and stats["server"]["warm_start_s"] > 0
    captures = capture.captures()
    warm = _ladder(db, prep)
    assert capture.captures() == captures, "a request captured a stored bucket"
    assert db.cache_stats()["traces"] == 0
    for (_, w), (_, c) in zip(warm, cold):
        _assert_bitwise(w, c)
    db.close()
    engine.clear_plan_cache()


def _v2(db):
    """Publish ``m`` v2 (the same spec trained on another seed), warmed
    onto the served route."""
    from repro_torch.data.datasets import make_hospital
    from repro_torch.ml import GradientBoostingClassifier, fit_pipeline

    train = make_hospital(1024, seed=1)
    pipe = fit_pipeline(
        train.joined_columns(), train.label, train.numeric, train.categorical,
        GradientBoostingClassifier(n_estimators=10, max_depth=3),
        categories=train.categories(),
    )
    return db.models.publish("m", pipe, warm="sync")


def test_cutover_of_a_warmed_version_captures_nothing(dev):
    """Publish v2 warmed onto the route's ladder, cut over: the requests
    after the swap run v2, capture no graph, and answer as v2's one-shot
    call (COUNT equal, AVG within rtol 1e-5)."""
    from repro_torch.exec import capture

    db, prep = _lifecycle_session(dev)
    _ladder(db, prep)
    assert _v2(db).state == "ready"
    captures, recompiles = capture.captures(), db.server.recompiles()
    db.models.cutover("m", 2)
    after = _ladder(db, prep)
    assert capture.captures() == captures and db.server.recompiles() == recompiles
    one_shot = db.sql(HOSPITAL_AGG.replace("'m'", "'m@2'")).prepare(
        transform="dnn", params=prep.params)
    from repro_torch.data.datasets import make_hospital

    for i, (served_by, out) in enumerate(after):
        assert served_by == "v2"
        want = one_shot(make_hospital(LIFECYCLE_SIZES[i], seed=30 + i).tables["patients"])
        assert np.array_equal(out["count_rows"], want["count_rows"])
        np.testing.assert_allclose(out["mean_score"], want["mean_score"], rtol=1e-5)
    assert db.server.route_snapshot("q")["last_cutover_deficit"] == 0
    db.close()


def test_a_ladder_past_the_capture_cache_shows_as_a_warm_deficit(dev, monkeypatch):
    """Two warmed versions of a three-bucket ladder in a cache of three
    graphs: warming v2 drops v1's graphs, which ``route_snapshot`` shows
    (``graph_evictions``, ``warm_deficit``) and a cutover back to v1 refuses
    until ``warm_version`` has captured them again."""
    from repro_torch.errors import RegistryStateError
    from repro_torch.exec import capture

    db, prep = _lifecycle_session(dev)
    capture.clear()
    monkeypatch.setattr(capture, "GRAPH_CAPACITY", len(LIFECYCLE_SIZES))
    _ladder(db, prep)
    _v2(db)
    snap = db.server.route_snapshot("q")["versions"]
    assert snap["v1"]["graph_evictions"] == len(LIFECYCLE_SIZES)
    assert snap["v1"]["graphs"] == 0 and snap["v1"]["warm_deficit"] == len(LIFECYCLE_SIZES)
    assert snap["v2"]["graphs"] == len(LIFECYCLE_SIZES) and snap["v2"]["warm_deficit"] == 0
    db.models.cutover("m", 2)  # v2 kept every graph it warmed
    with pytest.raises(RegistryStateError, match="not warm"):
        db.server.cutover("q", "v1", require_warm=True)
    assert db.server.warm_version("q", "v1") == len(LIFECYCLE_SIZES)
    db.server.cutover("q", "v1", require_warm=True)
    snap = db.server.route_snapshot("q")["versions"]
    assert snap["v1"]["warm_deficit"] == 0 and snap["v2"]["warm_deficit"] > 0
    db.close()


def test_a_one_shot_call_on_a_stored_bucket_counts_its_capture(dev, tmp_path):
    """A one-shot call is never warm-started, so in a fresh process its
    stored bucket is captured on the request path: the call counts that
    capture as a trace and claims no disk hit, as the cold call did, and
    answers as it bitwise."""
    import repro_torch as raven
    from repro_torch.data.datasets import make_hospital
    from repro_torch.exec import capture
    from repro_torch.relational import engine

    pipe, infer, t = _hospital_on_both(False)
    batch = make_hospital(1000, seed=30).tables["patients"]
    cache = str(tmp_path / "cache")

    def one_shot():
        engine.clear_plan_cache()  # a fresh process's state
        db = raven.connect(infer.tables, device=dev,
                           options=raven.ConnectOptions(cache_dir=cache))
        db.models.publish("m", pipe)
        prep = db.sql(HOSPITAL_AGG).prepare(transform="dnn", params={"t": t})
        before, captures = db.cache_stats(), capture.captures()
        out = prep(batch)
        after = db.cache_stats()
        db.close()  # drains the store's writer
        return out, {
            "traces": after["traces"] - before["traces"],
            "disk_hits": after["disk_hits"] - before["disk_hits"],
            "captures": capture.captures() - captures,
            "stage_hits": (after["artifact_store"]["stage_hits"]
                           - before["artifact_store"]["stage_hits"]),
        }

    cold, cold_n = one_shot()
    warm, warm_n = one_shot()
    engine.clear_plan_cache()
    assert cold_n["captures"] >= 1 and cold_n["stage_hits"] == 0
    assert warm_n["stage_hits"] == cold_n["captures"]  # the store held each bucket
    assert warm_n["captures"] == cold_n["captures"]
    assert warm_n["traces"] == warm_n["captures"] and warm_n["disk_hits"] == 0
    _assert_bitwise(warm, cold)


class _FailingSegmentAgg:
    """The kernel library with ``segment_agg``'s entry point reporting a
    CUDA error (1, invalid argument) in place of launching."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        if name == "raven_segment_agg":
            return lambda *args: 1
        return getattr(self._real, name)


def test_a_kernel_launch_error_never_trips_the_breaker(dev, monkeypatch):
    """``segment_agg`` reporting a launch error raises ``KernelError`` from
    the served group: its requests fail with it, the breaker (threshold 1)
    stays closed and no kernel-free fallback is compiled; once the kernel
    launches again the same route serves through it, as its one-shot call
    answers (COUNT equal, AVG within rtol 1e-5)."""
    import repro_torch as raven
    from repro_torch.data.datasets import make_hospital
    from repro_torch.exec import capture
    from repro_torch.kernels import _build
    from repro_torch.relational import engine

    engine.clear_plan_cache()
    capture.clear()
    pipe, infer, t = _hospital_on_both(False)
    db = raven.connect(infer.tables, device=dev)
    db.models.publish("m", pipe)
    prep = db.sql(HOSPITAL_AGG).prepare(transform="dnn", params={"t": t})
    prep.serve("q", options=raven.ServeOptions(breaker_threshold=1))
    batch = make_hospital(1000, seed=30).tables["patients"]
    real = _build.lib()
    with monkeypatch.context() as m:
        m.setattr(_build, "lib", lambda: _FailingSegmentAgg(real))
        for _ in range(2):
            req = prep.submit(batch)
            with pytest.raises(_build.KernelError, match="segment_agg"):
                db.flush()
            with pytest.raises(raven.RavenError) as ei:
                req.wait(timeout=60.0)
            assert isinstance(ei.value.__cause__, _build.KernelError)
    snap = db.server.route_snapshot("q")["versions"]["v1"]
    assert not snap["degraded"] and snap["breaker_trips"] == 0 and snap["errors"] == 2
    assert db.server.queries["q"].fallback is None
    launches = _build.LAUNCHES["segment_agg"]
    req = prep.submit(batch)
    db.flush()
    out = req.wait(timeout=60.0)
    assert _build.LAUNCHES["segment_agg"] > launches
    want = prep(batch)
    assert np.array_equal(out["count_rows"], want["count_rows"])
    np.testing.assert_allclose(out["mean_score"], want["mean_score"], rtol=1e-5)
    db.close()
    engine.clear_plan_cache()


# ---------------------------------------------------------------------------
# Training (the decoder LMs): the loss path on the card, the kernels' refusal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen2-moe-a2.7b", "llava-next-34b"])
def test_reduced_train_step_on_the_card_moves_every_leaf(dev, name):
    """One reduced bf16 train step on the card: every leaf's gradient
    finite and non-zero (none dropped by a kernel without a backward),
    every leaf moved but the norm weights (ones, whose bf16 spacing absorbs
    a step of lr 1e-3: no float32 master copy, as in the reference), and
    the loss within 1e-2 of the same step's on the CPU."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model, zoo
    from repro_torch.train.step import init_opt_state, make_train_step

    cfg = dataclasses.replace(reduced_config(name, dtype="bfloat16"), remat=True)
    losses = {}
    for where in ("cpu", dev):
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        params = {k: v for k, v in zoo._leaves(params)}
        before = {k: v.clone() for k, v in params.items()}
        params = zoo._nest({k: v.to(where) for k, v in params.items()})
        rng = np.random.default_rng(0)
        tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 96)), dtype=torch.int32)
        batch = {"tokens": tokens.to(where), "labels": tokens.roll(-1, 1).to(where)}
        if cfg.frontend == "vision":
            batch["patches"] = torch.randn((4, cfg.frontend_tokens, cfg.d_model),
                                           generator=torch.Generator().manual_seed(1)).to(where)
        step = make_train_step(model, lr=1e-3)
        params, _, m = step(params, init_opt_state(model, params), batch)
        losses[str(where)] = float(m["loss"])
        norms = {k: float(v) for k, v in m["grad_norms"].items()}
        assert all(np.isfinite(v) and v > 0 for v in norms.values()), norms
        still = [k for k, v in zoo._leaves(params) if torch.equal(v.cpu(), before[k])]
        # bf16 rounding absorbs a step of lr 1e-3 on the norm weights (ones)
        assert all(k.endswith(("ln1", "ln2", "final_norm")) and bool((before[k] == 1).all())
                   for k in still), still
    assert abs(losses["cpu"] - losses[str(dev)]) <= 1e-2 * losses["cpu"], losses


def test_attention_kernels_refuse_grad_on_the_card(dev):
    q = torch.randn(1, 64, 4, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention_op(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.decode_attention_op(q[:, 0], k, k, torch.full((1,), 64, device=dev))


# ---------------------------------------------------------------------------
# The attention kernels as registered operators (the dry run's route)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
def test_attention_operators_launch_the_kernels_on_the_card(dev, name):
    """On CUDA tensors under a dispatch mode ``kernels.ops`` goes through
    ``torch.ops.repro_torch.<name>``: the hand-written kernel launches (one
    launch counted), bitwise the ctypes wrapper called straight, and
    ``FlopCounterMode`` counts the operator's formula; with no mode it
    calls the wrapper (one launch, bitwise); under ``FakeTensorMode`` the
    fake implementation answers and nothing launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import attention as A

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 16, 8, 64, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(2, 16, 2, 64, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([16, 5], dtype=torch.int32, device=dev)
    if name == "flash_attention":
        args, direct = (q, k, k), lambda: A.flash_attention(q, k, k, causal=True, scale=0.125)
        call, flops = ops.flash_attention_op, 4 * 2 * 8 * 64 * (16 * 17 // 2)
    else:
        q = q[:, 0].contiguous()
        args, direct = (q, k, k, lengths), lambda: A.decode_attention(q, k, k, lengths,
                                                                       scale=0.125)
        call, flops = ops.decode_attention_op, 4 * 2 * 8 * 64 * 16
    before = LAUNCHES[name]
    with FlopCounterMode(display=False) as fc:
        got = call(*args)
    assert LAUNCHES[name] == before + 1
    assert fc.get_total_flops() == flops
    assert str(next(iter(fc.get_flop_counts()["Global"]))) == f"repro_torch.{name}"
    assert torch.equal(got, direct())
    before = LAUNCHES[name]
    assert torch.equal(call(*args), got) and LAUNCHES[name] == before + 1
    before = LAUNCHES[name]
    with FakeTensorMode() as mode:
        fake = call(*(mode.from_tensor(t) for t in args))
    assert LAUNCHES[name] == before and fake.shape == got.shape and fake.dtype == got.dtype
