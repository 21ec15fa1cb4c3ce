"""The redesigned relational kernels' algorithms and the two repaired port
faults, on the CPU, against the reference package.

* ``segment_agg``: a plain-torch model of the one-launch kernel's order of
  additions (``tests/torch_agg_model.py``) against the reference's Pallas
  kernel in interpret mode and its jnp oracle, on the same numpy inputs:
  bitwise on dyadic data (float32 sums are then exact in any order), within
  rtol 1e-5 elsewhere (sums in another order).
* ``gather_join``: the dimsort entry's direct-address index
  (``dense_index``) across dense, sparse, negative, int32-limit, empty and
  duplicate keys and its thresholds, and torch transcriptions of the
  kernel's two lookup routes
  (the records built from the index, and the search with its top levels
  staged) bitwise against the reference's Pallas kernel in interpret mode
  and its oracle.
* Integer constants are int32 and raise ``OverflowError`` past int32, as
  ``jnp.asarray`` does; ``tree_gemm`` plans programs past six decision
  words on the wide path instead of refusing them.

The CUDA kernels are held against the same models on the card by
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.relational import gather_join as pallas_gather_join
from repro.kernels.relational import segment_agg as pallas_segment_agg
from repro_torch.kernels import ref as tref
from repro_torch.kernels.relational import dense_records
from repro_torch.relational import engine as teng
from torch_agg_model import segment_agg_model

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


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


def _dyadic(rng, shape):
    return (rng.integers(-40, 40, size=shape) * 0.25).astype(np.float32)


# ---------------------------------------------------------------------------
# fault 1: integer constants
# ---------------------------------------------------------------------------


def _expr_modules(pkg):
    return (import_module(f"{pkg}.relational.engine"),
            import_module(f"{pkg}.relational.expr"))


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_int_constant_past_int32_raises_overflow(pkg):
    """ROADMAP Queue 3's smallest input: an int32 column compared with
    2**31. ``jnp.asarray`` refuses the constant; the port used to wrap it
    and count no rows."""
    eng, ex = _expr_modules(pkg)
    tables = {"t": {"k": np.array([3, -7, 5, I32_MAX], np.int32),
                    "v": np.ones(4, np.float32)}}
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}

    def plan(bound):
        return eng.Aggregate(eng.Filter(eng.Scan("t", ["k", "v"]), ex.Col("k") < bound),
                             [("n", "count", "v")])

    with pytest.raises(OverflowError, match="2147483648"):
        eng.execute_plan(plan(2**31), tables, **kw)
    n = eng.execute_plan(plan(I32_MAX), tables, **kw).to_numpy()["n"]
    assert np.asarray(n).tolist() == [3.0]


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
@pytest.mark.parametrize("value", [2**31, I32_MIN - 1])
def test_int_param_past_int32_raises_overflow(pkg, value):
    _, ex = _expr_modules(pkg)
    env = ({"k": jnp.zeros(3, jnp.int32)} if pkg == "repro"
           else {"k": torch.zeros(3, dtype=torch.int32)})
    with pytest.raises(OverflowError):
        ex.eval_expr(ex.Col("k") < ex.Param("t"), env, {"t": value})


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_int_constants_are_int32(pkg):
    _, ex = _expr_modules(pkg)
    env = ({"x": jnp.zeros(2, jnp.float32)} if pkg == "repro"
           else {"x": torch.zeros(2)})
    got = ex.eval_expr(ex.Const(1) + ex.Const(2), env)
    assert str(got.dtype).endswith("int32") and int(got) == 3
    edge = ex.eval_expr(ex.Const(I32_MIN) + ex.Const(0), env)
    assert str(edge.dtype).endswith("int32") and int(edge) == I32_MIN


# ---------------------------------------------------------------------------
# segment_agg: the kernel's order of additions
# ---------------------------------------------------------------------------


def _agg_inputs(N, C, S, dyadic, seed=0):
    rng = np.random.default_rng(seed + 7 * N + 13 * C + S)
    # else score-like values in [0, 1): no cancellation, so rtol is the
    # measure of a sum taken in another order
    vals = (_dyadic(rng, (N, C)) if dyadic
            else rng.random(size=(N, C)).astype(np.float32))
    w = (rng.random(N) > 0.3).astype(np.float32)  # a validity mask, as the stage gives
    sid = rng.integers(0, S, size=N).astype(np.int32)
    return vals, w, sid


def _check_agg(got, want, dyadic: bool, what: str) -> None:
    for g, x, name in zip(got, want, ("counts", "sums", "mins", "maxs")):
        g, x = _np(g), _np(x)
        if dyadic or name != "sums":
            _assert_bitwise(g, x, f"{what} {name}")
        else:
            assert g.shape == x.shape
            np.testing.assert_allclose(g, x, rtol=1e-5, atol=1e-6, err_msg=f"{what} {name}")


def _model(vals, w, sid, S, **kw):
    t = torch.from_numpy
    return segment_agg_model(t(vals), t(w), t(sid), num_segments=S, **kw)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("N", [0, 2500, 4099])
@pytest.mark.parametrize("C", [0, 1, 3])
@pytest.mark.parametrize("S", [1, 2, 8, 1024])
def test_segment_agg_model_vs_jnp_oracle(S, C, N, dyadic):
    """The kernel's planned launch (register path at S <= 8, shared path at
    S = 1,024; 1 to 3 blocks of ragged row ranges) against the jnp
    oracle."""
    vals, w, sid = _agg_inputs(N, C, S, dyadic)
    got = _model(vals, w, sid, S)
    want = jref.segment_agg_ref(jnp.asarray(vals), jnp.asarray(w), jnp.asarray(sid),
                                num_segments=S)
    _check_agg(got, want, dyadic, f"S={S} C={C} N={N}")


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("C", [0, 1, 3])
@pytest.mark.parametrize("S", [1, 2, 8, 1024])
def test_segment_agg_model_vs_pallas_interpret(S, C, dyadic):
    vals, w, sid = _agg_inputs(4099, C, S, dyadic, seed=1)
    got = _model(vals, w, sid, S)
    want = pallas_segment_agg(jnp.asarray(vals), jnp.asarray(w), jnp.asarray(sid),
                              num_segments=S, interpret=True)
    _check_agg(got, want, dyadic, f"S={S} C={C}")


@pytest.mark.parametrize("registers", [True, False])
@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_segment_agg_model_any_partition(blocks, registers):
    """Either path at any number of row ranges gives the oracle's bits on
    dyadic data and stays within rtol 1e-5 elsewhere."""
    for dyadic in (True, False):
        vals, w, sid = _agg_inputs(4099, 3, 8, dyadic, seed=2)
        got = _model(vals, w, sid, 8, blocks=blocks, registers=registers)
        want = tref.segment_agg_ref(torch.from_numpy(vals), torch.from_numpy(w),
                                    torch.from_numpy(sid), num_segments=8)
        _check_agg(got, want, dyadic, f"blocks={blocks} registers={registers}")


def test_segment_agg_model_non_finite_as_the_plain_version():
    """inf and NaN values: sums are NaN or inf only in their own segment,
    and a NaN among a segment's valid rows makes its min and max NaN, as the
    plain version (torch.amin / amax, index_add_) gives."""
    vals, w, sid = _agg_inputs(3000, 3, 8, False, seed=3)
    vals[::97, 0] = np.inf
    vals[5::211, 1] = np.nan
    vals[7::331, 2] = -np.inf
    t = torch.from_numpy
    got = _model(vals, w, sid, 8)
    want = tref.segment_agg_ref(t(vals), t(w), t(sid), num_segments=8)
    for g, x in zip(got, want):
        g, x = g.numpy(), x.numpy()
        assert np.array_equal(np.isnan(g), np.isnan(x))
        fin = ~np.isnan(x)
        np.testing.assert_allclose(g[fin], x[fin], rtol=1e-5, atol=1e-6)


def test_agg_plan_paths_and_partition():
    """The main path's folds take the register path in one launch, their
    partials staged for the last block's fold; the shared path's segments
    are cut into groups only where eight warp slices of them do not fit, and
    partials too large to stage are folded from L2."""
    from repro_torch.kernels.relational import AGG_SMEM, agg_plan

    for n, c, s in [(1 << 20, 3, 8), (1 << 20, 3, 1), (100_000, 1, 1)]:
        p = agg_plan(n, c, s, 132)
        assert p.registers and p.groups == 1 and p.stage and p.blocks * p.chunk >= n
        assert p.smem == max(4 * 8 * s * (3 * c + 1), 4 * p.blocks * s * (3 * c + 1))
    big = agg_plan(1 << 20, 3, 1024, 132)
    assert not big.registers and big.blocks == 132 and not big.stage
    assert big.groups == -(-1024 // big.group_segments) and big.smem <= AGG_SMEM
    assert agg_plan(20_000, 3, 256, 132).stage  # 10 blocks of 10 KB partials
    many = agg_plan(1 << 20, 3, 1 << 16, 132)
    assert many.groups > 1 and not many.stage
    assert many.groups * many.group_segments >= 1 << 16
    assert agg_plan(0, 3, 8, 132).blocks == 1


# ---------------------------------------------------------------------------
# gather_join: the dimsort index and the two lookup routes
# ---------------------------------------------------------------------------


def dense_lookup(fk, records, lo, P):
    """The dense route as the kernel runs it: a range check in int64, one
    record load, its payload words or zeros."""
    off = fk.to(torch.int64) - lo
    inside = (off >= 0) & (off < records.shape[0])
    rec = records[off.clamp(0, records.shape[0] - 1)]
    hit = inside & (rec[:, 0] >= 0)
    return torch.where(hit[:, None], rec[:, 1:1 + P].view(torch.float32), 0.0), hit


def search_lookup(fk, skeys, spay, sample=1024):
    """The search route as the kernel runs it: every 2^shift-th key (at
    most ``sample``) searched first, then the lower bound inside the bucket
    that search picks."""
    M = skeys.shape[0]
    if M == 0:
        return spay.new_zeros((fk.shape[0], spay.shape[1])), torch.zeros_like(fk, dtype=torch.bool)
    shift = 0
    while -(-M // (1 << shift)) > sample:
        shift += 1
    staged = skeys[:: 1 << shift].contiguous()
    a = torch.searchsorted(staged, fk, right=True).to(torch.int64)
    lo = torch.where(a == 0, 0, (a - 1) << shift)
    hi = torch.where(a == 0, 0, torch.clamp(a << shift, max=M))
    for _ in range(shift + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        less = skeys[mid.clamp(max=M - 1)] < fk
        lo, hi = torch.where(active & less, mid + 1, lo), torch.where(active & ~less, mid, hi)
    hit = (lo < M) & (skeys[lo.clamp(max=M - 1)] == fk)
    return torch.where(hit[:, None], spay[lo.clamp(max=M - 1)], 0.0), hit


JOIN_CASES = {  # name -> (dim keys, dense)
    "dense": (np.random.default_rng(1).choice(1000, 300, replace=False) + 37, True),
    "sparse": (np.random.default_rng(2).choice(1 << 28, 300, replace=False), False),
    "negative": (np.random.default_rng(3).choice(1000, 300, replace=False) - 600, True),
    "int32_low": (np.random.default_rng(4).choice(1000, 300, replace=False) + I32_MIN, True),
    "int32_high": (I32_MAX - np.random.default_rng(5).choice(1000, 300, replace=False), True),
    "int32_both": (np.concatenate([[I32_MIN, I32_MAX], np.random.default_rng(6).choice(
        1 << 20, 298, replace=False)]), False),
    "single": (np.array([-5]), True),
    "empty": (np.zeros(0), False),
}


def _join_case(name):
    keys, dense = JOIN_CASES[name]
    keys = keys.astype(np.int32)
    rng = np.random.default_rng(len(name))
    M = keys.size
    lo = int(keys.min()) - 50 if M else -50
    hi = int(keys.max()) + 50 if M else 50
    probe = rng.integers(max(lo, I32_MIN), min(hi, I32_MAX) + 1, size=400)
    hits = rng.choice(keys, size=400) if M else probe
    fk = np.concatenate([hits, probe, [I32_MIN, I32_MAX, 0, -1]]).astype(np.int32)
    return keys, fk, _dyadic(rng, (M, 3)), dense


@pytest.mark.parametrize("name", sorted(JOIN_CASES))
def test_dimsort_index_and_both_lookup_routes(name):
    keys, fk, pay, dense = _join_case(name)
    entry = teng.dimsort_entry(np.random.default_rng(0).permutation(keys), "cpu")
    sk = entry["keys"]
    assert "unique" in entry and torch.equal(sk, torch.sort(torch.from_numpy(keys)).values)
    assert "index" not in entry  # the plain version searches: no index on the CPU
    spay = torch.from_numpy(pay)[torch.from_numpy(np.argsort(keys, kind="stable"))]
    built = teng.dense_index(sk.numpy())
    assert (built is not None) == dense
    t_fk = torch.from_numpy(fk)
    want_out, want_hit = pallas_gather_join(jnp.asarray(fk), jnp.asarray(sk.numpy()),
                                            jnp.asarray(spay.numpy()), interpret=True)
    routes = {"search": search_lookup(t_fk, sk, spay),
              "search, 8 staged": search_lookup(t_fk, sk, spay, sample=8),
              "plain": tref.gather_join_ref(t_fk, sk, spay)}
    if dense:
        index, lo = built
        assert index.dtype == np.int32 and lo == int(keys.min())
        assert index.size == int(keys.max()) - lo + 1 <= 4 * keys.size
        assert np.array_equal(np.flatnonzero(index >= 0) + lo, np.sort(keys))
        assert np.array_equal(index[index >= 0], np.arange(keys.size))
        records = dense_records(torch.from_numpy(index), spay)
        assert records.shape == (index.size, 4) and records.dtype == torch.int32
        routes["dense"] = dense_lookup(t_fk, records, lo, spay.shape[1])
    if keys.size:  # the reference's oracle cannot index an empty dim table
        oracle = jref.gather_join_ref(jnp.asarray(fk), jnp.asarray(sk.numpy()),
                                      jnp.asarray(spay.numpy()))
        _assert_bitwise(oracle[0], want_out, "oracle payload")
        _assert_bitwise(oracle[1], want_hit, "oracle hits")
    for route, (out, hit) in routes.items():
        _assert_bitwise(out, want_out, f"{route} payload")
        _assert_bitwise(hit, want_hit, f"{route} hits")
    assert np.array_equal(_np(want_hit), np.isin(fk, keys))


def test_duplicate_keys_get_no_marker_and_no_index():
    entry = teng.dimsort_entry(np.array([4, 2, 4, 9], np.int32), "cpu")
    assert "unique" not in entry and "index" not in entry
    assert entry["keys"].tolist() == [2, 4, 4, 9] and entry["order"].tolist() == [1, 0, 2, 3]


def test_dense_index_thresholds(monkeypatch):
    """At most 4 slots a key, and 2^24 slots in all: the span is counted in
    int64, so keys at both int32 limits never wrap into a small span."""
    M = 100
    keys = np.arange(M, dtype=np.int32)
    keys[-1] = 4 * M - 1  # span exactly 4 M
    assert teng.dense_index(keys)[0].size == 4 * M
    keys[-1] = 4 * M
    assert teng.dense_index(keys) is None
    assert teng.DENSE_MAX_SLOTS == 1 << 24
    monkeypatch.setattr(teng, "DENSE_MAX_SLOTS", 256)
    keys = np.arange(M, dtype=np.int32) * 2  # span 199 <= 256
    assert teng.dense_index(keys)[0].size == 199
    keys[-1] = 256  # span 257 <= 4 M, > the cap
    assert teng.dense_index(keys) is None
    assert teng.dense_index(np.array([I32_MIN, I32_MAX], np.int32)) is None


def test_join_step_builds_the_sorted_payload_once(monkeypatch):
    """The Join step builds a dim table's sorted payload on its first run
    and keeps it in the dimsort entry: every later run of an uploaded
    database hands the op the same tensor."""
    from repro_torch.kernels import ops
    from repro_torch.relational.expr import Bin, Col, Const

    rng = np.random.default_rng(8)
    tables = {"d": {"k": np.arange(40, dtype=np.int64), "v": _dyadic(rng, 40)},
              "f": {"fk": rng.integers(0, 50, 300).astype(np.int64), "x": _dyadic(rng, 300)}}
    plan = teng.Aggregate(
        teng.Filter(teng.Join(teng.Scan("f", ["fk", "x"]), "d", "fk", "k", ["v"]),
                    Bin("gt", Col("x"), Const(0.0))),
        [("n", "count", "x"), ("s", "sum", "v")])
    calls = []
    real = ops.gather_join_op
    monkeypatch.setattr(ops, "gather_join_op", lambda *a, **k: calls.append(a) or real(*a, **k))
    db = teng.upload_database(tables, "cpu")
    cp = teng.compile_plan(plan, cache=False)
    first = cp.run(db, device="cpu").table.to_numpy()
    second = cp.run(db, device="cpu").table.to_numpy()
    assert len(calls) == 2 and calls[0][2] is calls[1][2]
    assert db.dimsort("d", "k")["payloads"][("v",)] == (calls[0][2], None)
    for k in first:
        _assert_bitwise(first[k], second[k], k)


# ---------------------------------------------------------------------------
# fault 2: tree_gemm past six decision words
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("I,F", [(256, 56), (1024, 56), (1024, 30_000)])
def test_tree_gemm_plans_wide_programs_on_the_wide_path(I, F):
    """A full depth-8 tree (255 nodes, padded to 256) and a 1,023-node one
    run on the wide path (no trees staged), x staged where it fits beside
    the rows' decision words."""
    from repro_torch.kernels.tree_gemm import (
        ROWS, SMEM_LIMIT, X_SMEM_LIMIT, XS, decision_words, launch_plan,
    )

    x_bytes = 4 * (F + 1) * XS
    words = 4 * decision_words(I) * ROWS
    assert launch_plan(F, 150, I, I) == (
        x_bytes <= X_SMEM_LIMIT and x_bytes + words <= SMEM_LIMIT, 0)


def test_tree_gemm_refuses_only_past_a_blocks_shared_memory():
    from repro_torch.kernels.tree_gemm import launch_plan

    assert launch_plan(56, 1, 7264, 7264)[1] == 0
    with pytest.raises(ValueError, match="decision words"):
        launch_plan(56, 1, 7296, 7296)
