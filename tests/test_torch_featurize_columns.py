"""``featurize`` reading its columns in place: the launch plan, the column
ranges of split launches, and the dispatch on column sequences, on the CPU.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here the parts around it are held against the reference package:

* ``featurize_plan`` (rows a tile, blocks, path, shared memory) and
  ``featurize_launches`` (disjoint column ranges past ``FEAT_MAX_COLS``
  inputs) at the hospital query's shape, Expedia's width and a row too wide
  for shared memory;
* a model of the kernel's indexing (tiles of the plan's rows, each launch's
  column range, its one-hot columns counted from the launch's first) that
  rebuilds the output from the launches alone, bitwise equal to the plain
  version;
* ``featurize_op`` on sequences of columns (contiguous, strided views,
  (N, k) inputs, other dtypes; Kn = 0, Kc = 0, N = 0) bitwise equal to the
  2-D form and to the reference's Pallas kernel in interpret mode on the
  same seeded numpy inputs;
* the compiled hospital program hands the featurize step the columns as
  they lie, and gives the reference's features bitwise and its scores
  within ``atol=1e-5`` (sums over trees in another order).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ml as jml
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.ml.pipeline import save_pipeline as ref_save_pipeline
from repro.tensor.compile import compile_pipeline_tensor as ref_compile
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.featurize import (
    FEAT_MAX_COLS,
    FEAT_MAX_ROWS,
    FEAT_SMEM,
    FEAT_SMEM_MAX,
    featurize_launches,
    featurize_plan,
    segment_columns,
)
from repro_torch.ml.pipeline import load_pipeline
from repro_torch.relational.table import to_device
from repro_torch.tensor.compile import compile_pipeline_tensor

H100_SMS = 132


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _segments(lengths):
    starts = np.cumsum([0] + list(lengths))[:-1]
    return tuple((int(s), int(n)) for s, n in zip(starts, lengths))


# ---------------------------------------------------------------------------
# featurize_plan and featurize_launches
# ---------------------------------------------------------------------------

HOSPITAL = (100_000, 9, 14, 40)
EXPEDIA = (8192, 8, 20, 3957)
TOO_WIDE = (300, 4, 2, 15_000)


def test_plan_at_the_hospital_shape_takes_full_tiles():
    plan = featurize_plan(*HOSPITAL, H100_SMS)
    assert not plan.stream and plan.rows == FEAT_MAX_ROWS
    assert plan.tiles == -(-HOSPITAL[0] // plan.rows)
    assert plan.smem <= FEAT_SMEM
    # several blocks an SM, as many as fit, and never more than the tiles
    assert 3 * H100_SMS <= plan.blocks <= plan.tiles


def test_plan_at_expedias_width_takes_a_narrow_tile():
    plan = featurize_plan(*EXPEDIA, H100_SMS)
    assert not plan.stream and plan.rows == 4
    assert plan.smem == 4 * 4 * (8 + 3957) + 2 * 4 * 28 * 5
    assert plan.smem <= FEAT_SMEM_MAX


def test_plan_for_a_row_too_wide_for_shared_memory_streams():
    plan = featurize_plan(*TOO_WIDE, H100_SMS)
    assert plan.stream
    assert plan.smem == 2 * 4 * 6 * (plan.rows + 1)  # the staged inputs only
    assert plan.tiles == -(-TOO_WIDE[0] // plan.rows) and plan.blocks == plan.tiles


@pytest.mark.parametrize("n_rows,n_num,n_cat,n_onehot", [
    HOSPITAL, EXPEDIA, TOO_WIDE, (1, 1, 0, 0), (5, 0, 3, 7), (1000, 64, 0, 0),
    (4097, 20, 44, 3000), (100, 3, 2, 14_000), (100, 3, 2, 14_600),
])
def test_plan_tiles_start_16_byte_aligned_and_fit(n_rows, n_num, n_cat, n_onehot):
    plan = featurize_plan(n_rows, n_num, n_cat, n_onehot, H100_SMS)
    width = n_num + n_onehot
    assert plan.rows % 4 == 0 and plan.rows >= 4
    assert plan.smem <= FEAT_SMEM_MAX
    assert plan.tiles * plan.rows >= n_rows > (plan.tiles - 1) * plan.rows
    assert 1 <= plan.blocks <= plan.tiles
    if not plan.stream:
        # the byte offset of every tile in the (N, F) f32 output
        assert all((t * plan.rows * width * 4) % 16 == 0 for t in range(plan.tiles))
        assert plan.smem == 4 * plan.rows * width + 8 * (n_num + n_cat) * (plan.rows + 1)


@pytest.mark.parametrize("n_num,lengths", [
    (9, (3, 2, 4, 3, 2, 2, 3, 3, 4, 2, 3, 4, 3, 2)),
    (70, (2,) * 70),
    (130, ()),
    (0, (3,) * 100),
    (64, (1,)),
    (3, (0, 5, 0, 7)),
])
def test_launches_write_disjoint_column_ranges(n_num, lengths):
    launches = featurize_launches(n_num, lengths)
    F = n_num + sum(lengths)
    covered = [c for ln in launches for c in range(*ln.out)]
    assert covered == list(range(F))  # contiguous ranges, in order, disjoint
    for ln in launches:
        n_in = (ln.num[1] - ln.num[0]) + (ln.cat[1] - ln.cat[0])
        assert 0 < n_in <= FEAT_MAX_COLS
        width = (ln.num[1] - ln.num[0]) + sum(lengths[ln.cat[0]:ln.cat[1]])
        assert ln.out[1] - ln.out[0] == width
    if n_num + len(lengths) <= FEAT_MAX_COLS:
        assert len(launches) == 1


# ---------------------------------------------------------------------------
# A model of the kernel's indexing, from the launches and plans alone
# ---------------------------------------------------------------------------


def _kernel_model(num_cols, cat_cols, offset, scale, cat_values, segments, max_cols):
    """What the kernel writes, launch by launch and tile by tile: a launch
    sees its numeric columns and its categorical columns from the first
    (``cat_base``), and its one-hot columns from its first output column."""
    Kn = len(num_cols)
    lengths = [n for _, n in segments]
    val_col = segment_columns(segments).numpy()
    N = (num_cols + cat_cols)[0].shape[0]
    out = np.full((N, Kn + sum(lengths)), np.nan, np.float32)
    for ln in featurize_launches(Kn, lengths, max_cols):
        (n0, n1), (k0, k1), (c0, c1) = ln
        kn = n1 - n0
        s0 = c0 + kn - Kn
        cols = num_cols[n0:n1] + cat_cols[k0:k1]
        plan = featurize_plan(N, kn, k1 - k0, c1 - c0 - kn, H100_SMS)
        for t in range(plan.tiles):
            r0, r1 = t * plan.rows, min(N, (t + 1) * plan.rows)
            staged = [c[r0:r1] for c in cols]
            for c in range(c1 - c0):
                if c < kn:
                    x = staged[c].astype(np.float32)
                    v = (x - offset[n0 + c]) * scale[n0 + c]
                else:
                    k = s0 + c - kn
                    j = kn + int(val_col[k]) - k0
                    v = (staged[j] == cat_values[k]).astype(np.float32)
                out[r0:r1, c0 + c] = v
    return out


@pytest.mark.parametrize("max_cols", [FEAT_MAX_COLS, 5, 2])
@pytest.mark.parametrize("n_num,lengths,N", [
    (9, (3, 2, 4, 3, 2, 2, 3, 3, 4, 2, 3, 4, 3, 2), 300),
    (7, (4, 0, 3), 129),
    (0, (3, 5, 2), 17),
    (6, (), 33),
])
def test_kernel_model_of_split_launches_matches_plain(max_cols, n_num, lengths, N):
    rng = np.random.default_rng(N + n_num)
    num = [rng.normal(size=N).astype(np.float32) for _ in range(n_num)]
    cat = [rng.integers(-1, n + 1, N).astype(np.int32) for n in lengths]
    offset = rng.normal(size=n_num).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=n_num).astype(np.float32)
    values = np.concatenate([np.arange(n) for n in lengths] or [np.zeros(0)]).astype(np.int32)
    segments = _segments(lengths)
    got = _kernel_model(num, cat, offset, scale, values, segments, max_cols)
    t = torch.from_numpy
    want = tref.featurize_ref(
        t(np.stack(num, 1) if num else np.zeros((N, 0), np.float32)),
        t(np.stack(cat, 1) if cat else np.zeros((N, 0), np.int32)),
        t(offset), t(scale), t(values), segments,
    )
    assert np.array_equal(_bits(got), _bits(want.numpy()))


# ---------------------------------------------------------------------------
# featurize_op on column sequences
# ---------------------------------------------------------------------------

LAYOUTS = ["columns", "strided", "wide", "dtypes"]


def _inputs(n_num, lengths, N, seed=7):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=(N, n_num)).astype(np.float32)
    cat = (np.stack([rng.integers(-1, n, N) for n in lengths], 1)
           if lengths else np.zeros((N, 0))).astype(np.int32)
    offset = rng.normal(size=n_num).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=n_num).astype(np.float32)
    values = np.concatenate([np.arange(n) for n in lengths] or [np.zeros(0)]).astype(np.int32)
    return num, cat, offset, scale, values, _segments(lengths)


def _as_columns(a: np.ndarray, layout: str, dtype) -> list[torch.Tensor]:
    """One numpy (N, K) block as the sequence of tensors a program hands
    the op: 1-D columns; strided views (every column a column of a wider
    tensor, or every other element of a longer one); (N, k) blocks; or
    columns of another dtype, converted on their own."""
    N, K = a.shape
    t = torch.from_numpy
    if layout == "columns":
        return [t(np.ascontiguousarray(a[:, j])) for j in range(K)]
    if layout == "strided":
        wide = t(np.concatenate([a, a[:, :1]], 1))
        long = [t(np.repeat(a[:, j], 2)) for j in range(K)]
        return [wide[:, j] if j % 2 else long[j][::2] for j in range(K)]
    if layout == "wide":
        return [t(a[:, j:j + 2].copy()) for j in range(0, K, 2)]
    return [t(a[:, j].astype(dtype)) for j in range(K)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n_num,lengths,N", [
    (9, (3, 2, 4, 3, 2, 2, 3, 3, 4, 2, 3, 4, 3, 2), 257),  # the hospital query's widths
    (0, (3, 5), 257),   # Kn = 0
    (4, (), 257),       # Kc = 0
    (5, (4, 4, 4), 0),  # N = 0
])
def test_featurize_op_on_columns_matches_2d_form_and_pallas(layout, n_num, lengths, N):
    num, cat, offset, scale, values, segments = _inputs(n_num, lengths, N)
    t = torch.from_numpy
    consts = (t(offset), t(scale), t(values), segments)
    num_cols = _as_columns(num, layout, np.float64)
    cat_cols = _as_columns(cat, layout, np.int64)
    got = tops.featurize_op(num_cols, cat_cols, *consts)
    two_d = tops.featurize_op(t(num), t(cat), *consts)
    assert got.shape == two_d.shape == (N, n_num + sum(lengths))
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got), _bits(two_d))
    args = (jnp.asarray(num), jnp.asarray(cat), jnp.asarray(offset),
            jnp.asarray(scale), jnp.asarray(values), segments)
    want = (jops.featurize_op(*args, interpret=True) if N else jref.featurize_ref(*args))
    assert np.array_equal(_bits(got), _bits(want))


def test_featurize_op_val_col_matches_segments():
    """A program's ``val_col`` buffer is the expansion the op builds."""
    num, cat, offset, scale, values, segments = _inputs(3, (2, 0, 3), 40)
    t = torch.from_numpy
    val_col = segment_columns(segments)
    assert val_col.tolist() == [0, 0, 2, 2, 2]
    got = tops.featurize_op(_as_columns(num, "columns", None), _as_columns(cat, "columns", None),
                            t(offset), t(scale), t(values), segments, val_col=val_col)
    assert np.array_equal(_bits(got), _bits(tops.featurize_op(
        t(num), t(cat), t(offset), t(scale), t(values), segments)))


def test_featurize_op_without_any_column_raises():
    """No column to take N from: an error, not a 0-row output."""
    f = torch.zeros(0)
    with pytest.raises(ValueError, match="no input tensor"):
        tops.featurize_op([], [], f, f, torch.zeros(0, dtype=torch.int32), ())


# ---------------------------------------------------------------------------
# The compiled hospital program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hospital_programs(tmp_path_factory):
    from repro.data.datasets import make_hospital

    ds = make_hospital(1024, seed=3)
    ref = jml.fit_pipeline(
        ds.joined_columns(), ds.label, ds.numeric, ds.categorical,
        jml.GradientBoostingClassifier(n_estimators=10, max_depth=3),
        categories=ds.categories(),
    )
    path = str(tmp_path_factory.mktemp("m") / "gb.npz")
    ref_save_pipeline(ref, path)
    return ref, load_pipeline(path), make_hospital(600, seed=9).joined_columns()


@pytest.mark.parametrize("use_kernels", [None, False])
@pytest.mark.parametrize("strategy", ["gemm", "traversal"])
def test_hospital_program_features_and_scores_match_reference(
        hospital_programs, monkeypatch, strategy, use_kernels):
    ref_pipe, port_pipe, rows = hospital_programs
    names = ref_pipe.input_names()
    comp = compile_pipeline_tensor(port_pipe, strategy=strategy, use_kernels=use_kernels,
                                   device="cpu")
    (info,) = [i for kind, _, i in comp.fn.steps if kind == "featurize"]
    cols = {n: to_device(rows[n], "cpu") for n in names}
    seen = {}
    real = tops.featurize_op

    def spy(num, cat, *a, **k):
        seen["num"], seen["cat"] = num, cat
        seen["out"] = real(num, cat, *a, **k)
        return seen["out"]

    monkeypatch.setattr(tops, "featurize_op", spy)
    got = comp.fn(cols)
    want = ref_compile(ref_pipe, strategy=strategy).fn({n: jnp.asarray(rows[n]) for n in names})
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, err_msg=k)
    num = np.stack([rows[c] for c in info["numeric"]], 1)
    cat = np.stack([rows[c] for c in info["categorical"]], 1)
    bufs = {k: v.numpy() for k, v in comp.fn.named_buffers()}
    want_x = jref.featurize_ref(
        jnp.asarray(num), jnp.asarray(cat), jnp.asarray(bufs[info["offset"]]),
        jnp.asarray(bufs[info["scale"]]), jnp.asarray(bufs[info["cat_values"]]),
        info["segments"],
    )
    if use_kernels is False:  # the plain composition: the op is not called
        assert not seen
        return
    # the op gets the program's input columns as they lie, not a stacked copy
    assert [c.data_ptr() for c in seen["num"]] == [cols[c].data_ptr() for c in info["numeric"]]
    assert [c.data_ptr() for c in seen["cat"]] == [
        cols[c].data_ptr() for c in info["categorical"]]
    assert np.array_equal(_bits(seen["out"]), _bits(want_x))
