"""CUDA kernel wrapper: fused featurization (scaler + one-hot + concat).

Replaces the Pallas ``featurize`` kernel of the reference package; the
kernel itself is ``csrc/featurize.cu``. The relational→model data conversion
is one pass: a row's raw numeric columns and categorical codes are read once,
where they lie (each column through its own pointer and row stride), and its
full feature row (numerics scaled, categoricals one-hot, concatenated
numerics-first) is written once.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import _build

FEAT_THREADS = 256  # the kernel's THREADS: eight warps
FEAT_MAX_COLS = 64  # input columns one launch takes (the kernel's MAXCOLS)
FEAT_MAX_ROWS = 128  # rows of a tile at most
FEAT_SMEM = 64 * 1024  # a tile's shared memory target: three blocks an SM or more
FEAT_SMEM_MAX = 232448  # a block's shared memory limit (227 KB)
FEAT_SM_SMEM = 233472  # an SM's shared memory (228 KB), 1 KB of it reserved a block
FEAT_SM_THREADS = 2048  # resident threads an SM
FEAT_STREAM_ROWS = 32  # rows of a stream-path tile (inputs staged only)


def segment_columns(cat_segments, device=None) -> torch.Tensor:
    """Expand static ``(start, length)`` one-hot segments into ``val_col``:
    for each one-hot output column, the categorical input column it tests."""
    cols = [j for j, (_, length) in enumerate(cat_segments) for _ in range(length)]
    return torch.tensor(cols, dtype=torch.int32, device=device)


class FeatPlan(NamedTuple):
    """One ``featurize`` launch: the stream path (no output tile in shared
    memory) or the tile path, ``rows`` a tile (a multiple of 4), ``tiles``
    in all, ``blocks`` taking them in turn, and the dynamic shared memory in
    bytes (the tile and two staging buffers)."""

    stream: bool
    rows: int
    tiles: int
    blocks: int
    smem: int


def _smem(rows: int, n_in: int, width: int, stream: bool) -> int:
    return (0 if stream else 4 * rows * width) + 2 * 4 * n_in * (rows + 1)


def featurize_plan(n_rows: int, n_num: int, n_cat: int, n_onehot: int, sms: int) -> FeatPlan:
    """The launch for N rows of ``n_num`` numeric and ``n_cat`` categorical
    input columns with ``n_onehot`` one-hot columns, on a card of ``sms``
    multiprocessors. A tile takes the most rows, a multiple of 4 and at most
    ``FEAT_MAX_ROWS``, whose tile and staging fit ``FEAT_SMEM``; a row too
    wide for that at 4 rows takes a 4-row tile up to ``FEAT_SMEM_MAX``, and
    past that the stream path. Blocks are as many as fit on the card at
    once, at most one a tile."""
    n_in, width = n_num + n_cat, n_num + n_onehot
    rows = FEAT_MAX_ROWS
    while rows > 4 and _smem(rows, n_in, width, False) > FEAT_SMEM:
        rows -= 4
    stream = _smem(rows, n_in, width, False) > FEAT_SMEM_MAX
    if stream:
        rows = FEAT_STREAM_ROWS
    smem = _smem(rows, n_in, width, stream)
    tiles = -(-n_rows // rows)
    per_sm = max(1, min(FEAT_SM_THREADS // FEAT_THREADS, FEAT_SM_SMEM // (smem + 1024)))
    return FeatPlan(stream, rows, tiles, max(1, min(tiles, sms * per_sm)), smem)


class FeatLaunch(NamedTuple):
    """The input and output columns of one launch: numeric inputs
    ``[num[0], num[1])``, categorical inputs ``[cat[0], cat[1])``, output
    columns ``[out[0], out[1])``."""

    num: tuple[int, int]
    cat: tuple[int, int]
    out: tuple[int, int]


def featurize_launches(n_num: int, lengths: Sequence[int],
                       max_cols: int = FEAT_MAX_COLS) -> list[FeatLaunch]:
    """The launches for ``n_num`` numeric columns and categorical columns
    with one-hot ``lengths``: one launch where all inputs fit ``max_cols``,
    else numeric launches and categorical launches of up to ``max_cols``
    inputs each, every one writing its own contiguous, disjoint column range
    of the same output. Launches with no output column are left out."""
    n_cat = len(lengths)
    ends = [0]
    for length in lengths:
        ends.append(ends[-1] + int(length))
    if n_num + n_cat <= max_cols:
        out = [FeatLaunch((0, n_num), (0, n_cat), (0, n_num + ends[-1]))]
    else:
        out = [FeatLaunch((lo, min(lo + max_cols, n_num)), (0, 0),
                          (lo, min(lo + max_cols, n_num)))
               for lo in range(0, n_num, max_cols)]
        for lo in range(0, n_cat, max_cols):
            hi = min(lo + max_cols, n_cat)
            out.append(FeatLaunch((0, 0), (lo, hi), (n_num + ends[lo], n_num + ends[hi])))
    return [ln for ln in out if ln.out[1] > ln.out[0]]


def _columns(x, dtype: torch.dtype, what: str, dev) -> tuple[list[tuple[int, int]], int | None]:
    """(pointer, row stride) of every column of ``x``, an (N, K) tensor or
    a sequence of (N,) or (N, k) tensors (a k-wide one gives k columns,
    read through its column stride); and N, where ``x`` holds a tensor."""
    parts = [x] if torch.is_tensor(x) else list(x)
    cols: list[tuple[int, int]] = []
    n = None
    for i, t in enumerate(parts):
        if not (torch.is_tensor(t) and t.device == dev and t.dtype == dtype
                and t.dim() in (1, 2)):
            raise ValueError(f"featurize: {what} input {i} is not a 1-D or 2-D {dtype} "
                             f"tensor on {dev}")
        if n is None:
            n = t.shape[0]
        elif t.shape[0] != n:
            raise ValueError(f"featurize: {what} input {i} has {t.shape[0]} rows, not {n}")
        if t.dim() == 1:
            cols.append((t.data_ptr(), t.stride(0)))
        else:
            cols += [(t.data_ptr() + k * t.stride(1) * t.element_size(), t.stride(0))
                     for k in range(t.shape[1])]
    return cols, n


def featurize(num, cat, offset, scale, cat_values, val_col, segments=None) -> torch.Tensor:
    """num: the Kn numeric columns, an (N,Kn) f32 tensor or a sequence of
    (N,) / (N,k) f32 tensors of any strides, read in place; cat likewise
    the Kc categorical int32 columns; offset/scale:(Kn,) f32; cat_values:
    (Vtot,) int32 concatenated category values; val_col:(Vtot,) int32 (see
    :func:`segment_columns`); ``segments`` the one-hot ``(start, length)``
    of each categorical column, in order, which splitting past
    ``FEAT_MAX_COLS`` inputs needs. All on one CUDA device. Returns
    (N, Kn + Vtot) f32."""
    dev = offset.device
    if dev.type != "cuda":
        raise ValueError(f"featurize kernel needs CUDA tensors, got {dev}")
    num_cols, n_num_rows = _columns(num, torch.float32, "numeric", dev)
    cat_cols, n_cat_rows = _columns(cat, torch.int32, "categorical", dev)
    if n_num_rows is None and n_cat_rows is None:
        raise ValueError("featurize: no input tensor to take the row count from")
    if None not in (n_num_rows, n_cat_rows) and n_num_rows != n_cat_rows:
        raise ValueError("featurize: numeric and categorical inputs disagree on N")
    N = n_num_rows if n_num_rows is not None else n_cat_rows
    Kn, Kc = len(num_cols), len(cat_cols)
    for t, name in ((offset, "offset"), (scale, "scale")):
        _build.require(t, name, torch.float32, 1, dev)
    _build.require(cat_values, "cat_values", torch.int32, 1, dev)
    _build.require(val_col, "val_col", torch.int32, 1, dev)
    Vtot = cat_values.shape[0]
    if offset.shape[0] != Kn or scale.shape[0] != Kn:
        raise ValueError("featurize: offset/scale need one entry per numeric column")
    if val_col.shape[0] != Vtot:
        raise ValueError("featurize: val_col must have one entry per category")
    if segments is None:
        lengths = None
    else:
        lengths = [int(length) for _, length in segments]
        starts = [sum(lengths[:j]) for j in range(len(lengths))]
        if (len(lengths) != Kc or sum(lengths) != Vtot
                or [int(s) for s, _ in segments] != starts):
            raise ValueError("featurize: segments must tile cat_values in order, one "
                             "per categorical column")
    F = Kn + Vtot
    out = torch.empty((N, F), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if Kn + Kc <= FEAT_MAX_COLS:
        launches = [FeatLaunch((0, Kn), (0, Kc), (0, F))]
    elif lengths is None:
        raise ValueError(f"featurize: more than {FEAT_MAX_COLS} input columns need segments")
    else:
        launches = featurize_launches(Kn, lengths)
    sms = _build.sm_count(dev)
    stream = _build.stream_ptr(dev)
    for ln in launches:
        (n0, n1), (k0, k1), (c0, c1) = ln
        cols = num_cols[n0:n1] + cat_cols[k0:k1]
        kn = n1 - n0
        s0 = c0 + kn - Kn  # the launch's first one-hot column (ignored where it has none)
        plan = featurize_plan(N, kn, k1 - k0, c1 - c0 - kn, sms)
        ptrs = (ctypes.c_void_p * max(len(cols), 1))(*(p for p, _ in cols))
        strides = (ctypes.c_longlong * max(len(cols), 1))(*(s for _, s in cols))
        with torch.cuda.device(dev):
            err = _build.lib().raven_featurize(
                ctypes.addressof(ptrs), ctypes.addressof(strides), kn, k1 - k0,
                offset.data_ptr() + 4 * n0, scale.data_ptr() + 4 * n0,
                cat_values.data_ptr() + 4 * max(s0, 0), val_col.data_ptr() + 4 * max(s0, 0),
                k0, c1 - c0 - kn, out.data_ptr() + 4 * c0, F, N, plan.rows,
                int(plan.stream), plan.blocks, plan.smem, stream,
            )
        _build.check("featurize", err)
        _build.launched("featurize")
    return out
