#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the port's hand-written CUDA kernels from
``src/repro_torch/kernels/csrc`` (``nvcc`` for ``sm_90a``, into
``build/repro_torch_kernels/``) and drives the port's main path through the
entry points a user calls: ``parse_prediction_query`` →
``RavenOptimizer.optimize`` (``transform="dnn"``) → ``compile_plan`` →
``CompiledPlan.run``. Two plans make up that path:

* the hospital prediction query ``QUERY`` over 100,000 rows, scored by a
  gradient-boosting model of 150 trees of depth 5 trained on 4,096 rows
  (one pure stage ``Scan→Filter→TensorOp→Filter→Aggregate``: the
  ``featurize``, ``tree_gemm`` and ``segment_agg`` kernels);
* the filter→join→aggregate dashboard plan over a star schema of 2^20 fact
  rows and 2^16 dim rows with dyadic values (``gather_join`` and
  ``segment_agg``), as a global fold and segmented into 6 requests.

In order it

1. prints the card's name and power limit, and the kernels' build time;
2. runs each plan once as a warm-up, recording the arguments every kernel
   wrapper is given there;
3. holds each kernel against its plain PyTorch version on the card on
   those arguments (``featurize``, ``gather_join`` and ``segment_agg`` on
   dyadic data bitwise; ``tree_gemm`` within 1e-5 and ``segment_agg`` on
   the model's scores within rtol 1e-5, sums over another order) and times
   it, its plain version and, where one exists, one PyTorch library call
   computing the same function, beside its bound on an H100;
4. zeroes every kernel's launch count and drives the main path: the
   prediction query for three bindings of ``:t``, checked against the
   numpy host interpreter ``run_pipeline``; the dashboard plan, global and
   segmented, bitwise against a numpy host oracle and between
   ``RAVEN_KERNELS`` on and off; then reads the counts, each of which must
   be above 0 on the plan that reaches its kernel;
5. prints the kernel table as one JSON line and, last, the device line
   ``{"ok": true, "device": {...}}``.

It catches nothing: any failed check raises and the exit code is not 0.
Without a card it exits non-zero before printing any result, as it does
when the rest of the repository is not beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # fp32 outside the tensor cores

TRAIN_ROWS, INFER_ROWS = 4096, 100_000
N_ESTIMATORS, MAX_DEPTH = 150, 5
FACT_ROWS, DIM_ROWS = 1 << 20, 1 << 16
N_REQUESTS = 6  # segments of the segmented dashboard run
QUERY = (
    "SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) AS p "
    "WHERE asthma = 1 AND score >= :t"
)
MEASURES = ("x", "v0", "v1")

# kernel -> (wrapper module, its source, the Pallas function it replaces)
KERNELS = {
    "featurize": ("repro_torch.kernels.featurize",
                  "src/repro_torch/kernels/csrc/featurize.cu",
                  "src/repro/kernels/featurize.py:41"),
    "tree_gemm": ("repro_torch.kernels.tree_gemm",
                  "src/repro_torch/kernels/csrc/tree_gemm.cu",
                  "src/repro/kernels/tree_gemm.py:46"),
    "gather_join": ("repro_torch.kernels.relational",
                    "src/repro_torch/kernels/csrc/gather_join.cu",
                    "src/repro/kernels/relational.py:63"),
    "segment_agg": ("repro_torch.kernels.relational",
                    "src/repro_torch/kernels/csrc/segment_agg.cu",
                    "src/repro/kernels/relational.py:143"),
}


def wrapper(name: str):
    from importlib import import_module

    return getattr(import_module(KERNELS[name][0]), name)


# ---------------------------------------------------------------------------
# Workloads and their host oracles
# ---------------------------------------------------------------------------


def gap_thresholds(scores, quantiles, min_gap: float = 2e-5) -> list[float]:
    """Bindings of ``:t`` near the given quantiles of the host scores,
    mid-way in the widest gap between consecutive scores among the next
    1,000: the card sums the trees in float32 and in another order than the
    host's float64 (differences near 1e-7), and such last-bit differences
    must not move a row across ``t``."""
    s = np.unique(np.asarray(scores, np.float64))
    out = []
    for q in quantiles:
        i = int(q * (len(s) - 2))
        gaps = np.diff(s[i : i + 1001])
        j = i + int(np.argmax(gaps))
        check(s[j + 1] - s[j] >= min_gap, f"no score gap of {min_gap} near q={q}")
        out.append(float(np.float32((s[j] + s[j + 1]) / 2)))
    return out


def hospital_case(train_rows, infer_rows, n_estimators, max_depth, seed=0):
    """Train the model with the port's trainer; returns the query, the
    inference tables and the host oracle's inputs."""
    from repro_torch.data.datasets import make_hospital
    from repro_torch.ml import GradientBoostingClassifier, fit_pipeline, run_pipeline
    from repro_torch.sql.parser import parse_prediction_query

    train = make_hospital(train_rows, seed=seed)
    infer = make_hospital(infer_rows, seed=seed)
    t0 = time.perf_counter()
    pipe = fit_pipeline(
        train.joined_columns(), train.label, train.numeric, train.categorical,
        GradientBoostingClassifier(n_estimators=n_estimators, max_depth=max_depth),
        categories=train.categories(),
    )
    train_s = time.perf_counter() - t0
    cols = infer.joined_columns()
    score = run_pipeline(pipe, {n: cols[n] for n in pipe.input_names()})[pipe.outputs[0]]
    query = parse_prediction_query(QUERY, {"m": pipe}, infer.tables)
    return {
        "query": query, "tables": infer.tables, "train_s": train_s,
        "score": np.asarray(score, np.float64), "asthma": np.asarray(cols["asthma"]),
    }


def hospital_oracle(case, t: float) -> tuple[int, float]:
    mask = (case["asthma"] == 1) & (case["score"] >= t)
    return int(mask.sum()), float(case["score"][mask].mean())


def dashboard_tables(n_rows: int, m_dim: int, seed: int):
    """Star schema with dyadic values (small integers times 0.25): float32
    sums are exact in any order. A fifth of the fact keys miss the dim."""
    rng = np.random.default_rng(seed)

    def dy(shape):
        return (rng.integers(-40, 40, size=shape) * 0.25).astype(np.float32)

    dim = {"k": np.arange(m_dim, dtype=np.int64), "v0": dy(m_dim), "v1": dy(m_dim)}
    fact = {"fk": rng.integers(0, m_dim + m_dim // 4, size=n_rows).astype(np.int64),
            "x": dy(n_rows)}
    return {"f": fact, "d": dim}


def dashboard_plan():
    """count, and sum/avg/min/max of every measure, over the fact rows with
    x > 0 that join the dim table."""
    from repro_torch.relational.engine import Aggregate, Filter, Join, Scan
    from repro_torch.relational.expr import Bin, Col, Const

    aggs = [("n", "count", "x")]
    for c in MEASURES:
        aggs += [(f"sum_{c}", "sum", c), (f"avg_{c}", "mean", c),
                 (f"min_{c}", "min", c), (f"max_{c}", "max", c)]
    return Aggregate(
        Filter(Join(Scan("f", ["fk", "x"]), "d", "fk", "k", ["v0", "v1"]),
               Bin("gt", Col("x"), Const(0.0))),
        aggs,
    )


def dashboard_oracle(fact, dim) -> dict[str, np.float32]:
    """numpy filter→join→aggregate; on dyadic data the float64 sums are
    exact in float32."""
    pos = np.clip(np.searchsorted(dim["k"], fact["fk"]), 0, len(dim["k"]) - 1)
    mask = (dim["k"][pos] == fact["fk"]) & (fact["x"] > 0)
    p = pos[mask]
    n = np.float32(mask.sum())
    out = {"n": n}
    for c in MEASURES:
        v = fact["x"][mask] if c == "x" else dim[c][p]
        s = np.float32(v.astype(np.float64).sum())
        out[f"sum_{c}"] = s
        out[f"avg_{c}"] = s / max(n, np.float32(1))
        out[f"min_{c}"] = v.min() if len(v) else np.float32(0)
        out[f"max_{c}"] = v.max() if len(v) else np.float32(0)
    return out


def check(ok, what) -> None:
    """A failed check raises (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def check_bitwise(got: dict, want: dict, what: str) -> None:
    check(sorted(got) == sorted(want), (what, sorted(got), sorted(want)))
    for k in want:
        g = np.asarray(got[k], np.float32).reshape(-1)
        w = np.asarray(want[k], np.float32).reshape(-1)
        check(g.shape == w.shape and np.isfinite(g).all(), (what, k, g, w))
        check(np.array_equal(bits(g), bits(w)), f"{what}: {k} {g} != {w}")


# ---------------------------------------------------------------------------
# Driving the plans
# ---------------------------------------------------------------------------


def compile_hospital(case, device):
    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
    from repro_torch.relational.engine import compile_plan, upload_database

    plan, report = RavenOptimizer(
        options=OptimizerOptions(transform="dnn")
    ).optimize(case["query"])
    return compile_plan(plan), report, upload_database(case["tables"], device)


def run_hospital(cp, db, t: float, device) -> tuple[int, float, float]:
    """One request; returns (COUNT, AVG, milliseconds to the host result)."""
    t0 = time.perf_counter()
    out = cp.run(db, params={"t": t}, device=device).table.to_numpy()
    ms = 1e3 * (time.perf_counter() - t0)
    count, avg = out["count_rows"], out["mean_score"]
    check(count.shape == avg.shape == (1,) and np.isfinite(avg).all(), out)
    return int(count[0]), float(avg[0]), ms


def run_dashboard(tables, device, mode: str, segments=None) -> dict:
    """The dashboard plan under ``RAVEN_KERNELS=mode``, compiled afresh (the
    mode is read when the stage graph is built)."""
    from repro_torch.relational.engine import compile_plan, upload_database

    prev = os.environ.get("RAVEN_KERNELS")
    os.environ["RAVEN_KERNELS"] = mode
    try:
        cp = compile_plan(dashboard_plan(), cache=False)
    finally:
        if prev is None:
            del os.environ["RAVEN_KERNELS"]
        else:
            os.environ["RAVEN_KERNELS"] = prev
    db = upload_database(tables, device)
    return cp.run(db, segments=segments, device=device).table.to_numpy()


def check_dashboard(tables, seg, device) -> None:
    """Global and segmented folds: bitwise against the host oracle and
    between the kernels and the legacy composition."""
    on = run_dashboard(tables, device, "on")
    check_bitwise(on, dashboard_oracle(tables["f"], tables["d"]), "dashboard vs host")
    check_bitwise(run_dashboard(tables, device, "off"), on, "dashboard on vs off")
    son = run_dashboard(tables, device, "on", segments=(seg, N_REQUESTS))
    soff = run_dashboard(tables, device, "off", segments=(seg, N_REQUESTS))
    check_bitwise(son, soff, "segmented on vs off")
    for r in range(N_REQUESTS):
        fact = {c: v[seg == r] for c, v in tables["f"].items()}
        want = dashboard_oracle(fact, tables["d"])
        check_bitwise({k: v[r] for k, v in son.items()}, want, f"segment {r} vs host")


# ---------------------------------------------------------------------------
# Kernel parity, timing and bounds
# ---------------------------------------------------------------------------


class Recorder:
    """For the warm-up run only: wraps every kernel wrapper so that each
    call's arguments (the tensors the main path hands the kernel) are kept.
    The wrappers still count these launches; the counts are zeroed before
    the main path is driven."""

    def __init__(self):
        self.calls: list[tuple[str, str, tuple, dict]] = []
        self.label = ""
        self._saved = []

    def __enter__(self):
        from importlib import import_module

        for name, (mod, _, _) in KERNELS.items():
            module = import_module(mod)
            real = getattr(module, name)

            def rec(*a, _real=real, _name=name, **k):
                self.calls.append((_name, self.label, a, k))
                return _real(*a, **k)

            self._saved.append((module, name, real))
            setattr(module, name, rec)
        return self

    def __exit__(self, *exc):
        for module, name, real in self._saved:
            setattr(module, name, real)
        return False


def time_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, fp32_ops: int) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    fp32 operations over the fp32 rate, whichever is larger."""
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    t_ops = 1e3 * fp32_ops / FP32_FLOPS_PER_S
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def tree_gemm_fp64(x, A, B, C, D, V, base) -> torch.Tensor:
    """The plain version's chain with the sum over trees in float64."""
    S = torch.einsum("nf,tfi->nti", x, A)
    P = torch.einsum("nti,til->ntl", (S <= B[None]).to(torch.float32), C)
    match = (P == D[None]).to(torch.float64)
    return (torch.einsum("ntl,tl->n", match, V.to(torch.float64)) + base).to(torch.float32)


def parity_site(name: str, args: tuple, kwargs: dict, dyadic: bool) -> dict:
    """One recorded call: kernel against plain version, times and bound."""
    from repro_torch.kernels import ref

    kern = wrapper(name)
    library = None
    if name == "featurize":
        num, cat, offset, scale, values, val_col = args
        lens = np.bincount(val_col.cpu().numpy(), minlength=cat.shape[1])
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        segments = tuple((int(s), int(n)) for s, n in zip(starts, lens))
        plain = lambda: ref.featurize_ref(num, cat, offset, scale, values, segments)  # noqa: E731
        got, want = kern(*args), plain()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        check(np.array_equal(bits(got.cpu()), bits(want.cpu())), "featurize not bitwise")
        N, Kn = num.shape
        Vtot = values.shape[0]
        moved = nbytes(num, cat, offset, scale, values, val_col, got)
        ops_ = N * (2 * Kn + Vtot)
        shape = f"N={N} Kn={Kn} Kc={cat.shape[1]} Vtot={Vtot}"
    elif name == "tree_gemm":
        x, A, B, C, D, V, base = args
        xp = torch.nn.functional.pad(x, (0, A.shape[1] - x.shape[1]))
        plain = lambda: ref.tree_gemm_ref(xp, A, B, C, D, V, base)  # noqa: E731
        got, want = kern(*args), plain()
        err = float((got - want).abs().max())
        exact = tree_gemm_fp64(xp, A, B, C, D, V, base)
        print(f"tree_gemm vs an fp64 sum: kernel {float((got - exact).abs().max())!r}"
              f" plain {float((want - exact).abs().max())!r}", flush=True)
        check(err <= 1e-5, f"tree_gemm off by {err}")
        N, Fx = x.shape
        T, _, I = A.shape
        L = C.shape[2]
        moved = nbytes(x, A, B, C, D, V, got)
        # what this program's trees need, padding left out: A is one-hot, so
        # S = x.A is a gather and one compare per internal node; then
        # P = D.C over internal x leaf nodes and y += match.V over the leaves
        n_int = (A != 0).any(dim=1).sum(dim=1).double()  # per tree
        n_leaf = (D >= 0).sum(dim=1).double()
        ops_ = N * int((n_int + 2 * n_int * n_leaf + 2 * n_leaf).sum())
        shape = f"N={N} F={Fx} (program {A.shape[1]}) T={T} I={I} L={L}"
    elif name == "gather_join":
        fk, skeys, spay = args
        plain = lambda: ref.gather_join_ref(fk, skeys, spay)  # noqa: E731
        (out, hit), (wout, whit) = kern(*args), plain()
        err = float((out - wout).abs().max()) if out.numel() else 0.0
        check(np.array_equal(bits(out.cpu()), bits(wout.cpu())), "gather_join payload")
        check(torch.equal(hit, whit), "gather_join hit mask")
        M, P = spay.shape

        def library():  # search and gather; misses are not zeroed
            pos = torch.searchsorted(skeys, fk).clamp_(max=M - 1)
            return spay.index_select(0, pos)

        moved = nbytes(fk, skeys, spay, out, hit)
        ops_ = 0  # integer compares and copies only
        shape = f"N={fk.shape[0]} M={M} P={P}"
    else:  # segment_agg
        vals, w, sid = args
        S = kwargs["num_segments"]
        plain = lambda: ref.segment_agg_ref(vals, w, sid, num_segments=S)  # noqa: E731
        got, want = kern(*args, **kwargs), plain()
        err = 0.0
        for g, x, what in zip(got, want, ("counts", "sums", "mins", "maxs")):
            g, x = g.cpu().numpy(), x.cpu().numpy()
            fin = np.isfinite(x)
            check(np.array_equal(np.isfinite(g), fin) and np.array_equal(g[~fin], x[~fin]), what)
            if g.size:
                err = max(err, float(np.abs(g[fin] - x[fin]).max(initial=0.0)))
            if dyadic or what in ("counts", "mins", "maxs"):
                check(np.array_equal(bits(g), bits(x)), f"segment_agg {what} not bitwise")
            else:  # the model's scores: sums in another order
                np.testing.assert_allclose(g, x, rtol=1e-5)
        N, C = vals.shape
        moved = nbytes(vals, w, sid, *got)
        ops_ = N * (1 + 4 * C)  # w sum; v*w, its sum, min, max per column
        shape = f"N={N} C={C} S={S}"
    torch.cuda.synchronize()
    b_ms, b_by = bound(moved, ops_)
    run = lambda: kern(*args, **kwargs)  # noqa: E731
    return {
        "name": name, "shape": shape, "max_abs_err": err,
        "ms": time_ms(run, 50), "plain_ms": time_ms(plain, 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library, 20) if library is not None else None,
    }


def parity_phase(calls) -> dict[str, dict]:
    """Every distinct call site of the warm-up; per kernel, the row for its
    largest site (max_abs_err is the largest over all its sites)."""
    rows: dict[str, dict] = {}
    seen = set()
    for name, label, args, kwargs in calls:
        key = (name, label, tuple(tuple(a.shape) for a in args if torch.is_tensor(a)),
               tuple(sorted(kwargs.items())))
        if key in seen:
            continue
        seen.add(key)
        row = parity_site(name, args, kwargs, dyadic=label.startswith("dashboard"))
        print(f"parity {name:<11} [{label}] {row['shape']}: max_abs_err="
              f"{row['max_abs_err']!r} ms={row['ms']!r} plain_ms={row['plain_ms']!r} "
              f"bound_ms={row['bound_ms']!r} ({row['bound_by']}) "
              f"library_ms={row['library_ms']!r}", flush=True)
        best = rows.get(name)
        if best is None or row["bound_ms"] > best["bound_ms"]:
            if best is not None:
                row["max_abs_err"] = max(row["max_abs_err"], best["max_abs_err"])
            rows[name] = row
        else:
            best["max_abs_err"] = max(row["max_abs_err"], best["max_abs_err"])
    check(sorted(rows) == sorted(KERNELS), f"kernels reached: {sorted(rows)}")
    return rows


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # the plain versions' float32 contractions run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.lib()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)

    case = hospital_case(TRAIN_ROWS, INFER_ROWS, N_ESTIMATORS, MAX_DEPTH)
    print(f"trained {N_ESTIMATORS} trees of depth {MAX_DEPTH} on {TRAIN_ROWS} "
          f"rows in {case['train_s']:.1f} s", flush=True)
    thresholds = gap_thresholds(case["score"], (0.4, 0.5, 0.6))
    cp, report, db = compile_hospital(case, dev)
    print("hospital plan:", report.stages, report.notes, report.relational, flush=True)
    tables = dashboard_tables(FACT_ROWS, DIM_ROWS, seed=60)
    seg = np.sort(np.random.default_rng(2).integers(0, N_REQUESTS, size=FACT_ROWS)
                  ).astype(np.int32)

    # warm-up, recording what the main path hands each kernel
    with Recorder() as rec:
        rec.label = "hospital"
        run_hospital(cp, db, thresholds[1], dev)
        rec.label = "dashboard"
        run_dashboard(tables, dev, "on")
        rec.label = "dashboard-segmented"
        run_dashboard(tables, dev, "on", segments=(seg, N_REQUESTS))
    rows = parity_phase(rec.calls)
    del rec

    # the main path, counted
    for name in KERNELS:
        _build.LAUNCHES[name] = 0
    for t in thresholds:
        count, avg, ms = run_hospital(cp, db, t, dev)
        want_count, want_avg = hospital_oracle(case, t)
        print(f"hospital t={t!r}: COUNT={count} AVG={avg!r} host COUNT={want_count} "
              f"AVG={want_avg!r} request_ms={ms!r}", flush=True)
        check(count == want_count > 0, (count, want_count))
        check(abs(avg - want_avg) <= 1e-5 * abs(want_avg), (avg, want_avg))
    model_counts = dict(_build.LAUNCHES)
    print("launches after the prediction query:", model_counts, flush=True)
    check(all(model_counts[n] > 0 for n in ("featurize", "tree_gemm", "segment_agg")),
          f"a model kernel was not launched: {model_counts}")
    check_dashboard(tables, seg, dev)
    counts = dict(_build.LAUNCHES)
    print("launches after the dashboard plan:", counts, flush=True)
    check(counts["gather_join"] > 0 and counts["segment_agg"] > model_counts["segment_agg"],
          f"a relational kernel was not launched: {counts}")
    print("dashboard: global and segmented bitwise vs host and on vs off", flush=True)

    table = []
    for name, (_, source, replaces) in KERNELS.items():
        row = rows[name]
        table.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"],
        })
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
