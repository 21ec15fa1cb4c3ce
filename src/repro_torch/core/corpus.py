"""Strategy-training corpus: pipelines shaped like the OpenML CC-18 study.

The paper trains its runtime-selection strategies on 138 OpenML pipelines,
measuring each under every transformation and labeling with the fastest
(§5.2). CC-18 is unavailable offline, so we *generate* a corpus matching the
paper's Fig. 1 distributions — inputs (median ≈ 21, heavy tail), categorical
fraction with OHE cardinalities, model mix (≈88% tree-based / 12% linear),
tree counts and depths spanning stumps to deep forests — then measure
best-runtime labels on THIS hardware and OUR backends, which is exactly the
paper's prescription ("users re-train the strategy on their workload and
hardware").

The port measures on the run's device, the card unless the caller asks for
the CPU: :func:`_measure` uploads each measuring batch once and times the
``sql`` and ``dnn`` legs through the engine's plan cache, waiting for the
card at the end of each call. Everything else (the pipeline sampler, the
trainer, the draws from the shared generator) is the reference's, so
``build_corpus(seed=s)`` trains the reference's pipelines for ``s``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.stats import pipeline_stats
from repro_torch.core.strategies import TRANSFORMS
from repro_torch.ml import (
    DecisionTreeClassifier,
    GradientBoostingClassifier,
    LogisticRegression,
    RandomForestClassifier,
    fit_pipeline,
)
from repro_torch.ml.pipeline import TrainedPipeline, run_pipeline


@dataclass
class Corpus:
    pipelines: list[TrainedPipeline]
    stats: np.ndarray  # (n, 22)
    runtimes: np.ndarray  # (n, 3) seconds per transform, measured
    labels: np.ndarray  # (n,) argmin over transforms


def _sample_pipeline_spec(rng: np.random.Generator) -> dict:
    """One pipeline spec following Fig. 1's marginals."""
    n_inputs = int(np.clip(rng.lognormal(np.log(21), 0.8), 3, 120))
    frac_cat = rng.uniform(0.0, 0.7)
    n_cat = int(round(n_inputs * frac_cat))
    n_num = max(1, n_inputs - n_cat)
    cards = rng.choice([2, 3, 4, 6, 8, 12, 24, 48], size=n_cat).astype(int)
    model = rng.choice(
        ["dt", "rf", "gb", "lr"], p=[0.3, 0.29, 0.29, 0.12]
    )
    depth = int(np.clip(rng.lognormal(np.log(6), 0.7), 2, 16))
    n_trees = (
        1 if model == "dt"
        else int(np.clip(rng.lognormal(np.log(12), 0.9), 2, 120))
    )
    return {
        "n_num": n_num, "n_cat": n_cat, "cards": cards, "model": model,
        "depth": depth, "n_trees": n_trees,
    }


def _make_estimator(spec: dict, rng):
    m = spec["model"]
    if m == "dt":
        return DecisionTreeClassifier(max_depth=spec["depth"])
    if m == "rf":
        return RandomForestClassifier(
            n_estimators=spec["n_trees"], max_depth=spec["depth"],
            seed=int(rng.integers(1 << 30)),
        )
    if m == "gb":
        return GradientBoostingClassifier(
            n_estimators=spec["n_trees"], max_depth=min(spec["depth"], 8),
            seed=int(rng.integers(1 << 30)),
        )
    return LogisticRegression(alpha=float(rng.choice([0.0, 0.001, 0.01])), n_iter=60)


def _train_one(spec: dict, rng, n_rows: int = 1024) -> TrainedPipeline:
    cols = {f"n{i}": rng.normal(size=n_rows) for i in range(spec["n_num"])}
    cats = {
        f"c{i}": rng.integers(0, c, n_rows)
        for i, c in enumerate(spec["cards"])
    }
    z = sum(
        rng.normal() * v for v in list(cols.values())[:: max(1, spec["n_num"] // 4)]
    )
    y = (z + rng.normal(size=n_rows) > 0).astype(np.int64)
    return fit_pipeline(
        {**cols, **cats}, y, list(cols), list(cats),
        _make_estimator(spec, rng),
        categories={k: np.arange(c) for k, c in
                    zip(cats, spec["cards"])},
    )


def _measure(pipe: TrainedPipeline, n_rows: int, rng, repeats: int = 2,
             device=None) -> np.ndarray:
    """Wall-time per transform on a measurement batch (median of repeats).

    The batch is drawn from ``rng`` as the reference draws it (one normal
    column per numeric input, one ``integers(0, 4)`` column per categorical,
    in input order) and uploaded once to ``device`` (default the card). The
    sql/dnn variants run as compiled plans (the path serving uses), kept out
    of the plan cache and their graphs released once timed, so a corpus
    pushes no live plan or graph out of either cache; each call ends in a
    wait for the card. The first call of each variant is dropped: on the
    card it captures the stage's CUDA graph, and the timed calls replay it.
    """
    from repro_torch.core.rules.ml_to_sql import (
        MLtoSQLUnsupported,
        compile_pipeline_to_sql,
    )
    from repro_torch.device import resolve_device
    from repro_torch.relational.engine import (
        Project,
        Scan,
        TensorOp,
        compile_plan,
        upload_database,
    )
    from repro_torch.tensor.compile import compile_pipeline_tensor

    dev = resolve_device(device)
    batch = {}
    for s in pipe.inputs:
        if s.kind == "numeric":
            batch[s.name] = rng.normal(size=n_rows)
        else:
            batch[s.name] = rng.integers(0, 4, n_rows)

    times = np.full(len(TRANSFORMS), np.inf)

    # none: interpreted runtime
    ts = []
    for _ in range(repeats + 1):
        t0 = time.perf_counter()
        run_pipeline(pipe, batch)
        ts.append(time.perf_counter() - t0)
    times[0] = float(np.median(ts[1:]))

    scan = Scan("batch", list(pipe.input_names()))
    db = upload_database(
        {"batch": {k: np.asarray(v, np.float32) for k, v in batch.items()}}, dev
    )

    def timed(plan) -> float:
        compiled = compile_plan(plan, cache=False)
        ts = []
        try:
            for _ in range(repeats + 1):
                t0 = time.perf_counter()
                compiled.run(db, device=dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                ts.append(time.perf_counter() - t0)
        finally:
            compiled.release()
        return float(np.median(ts[1:]))

    # sql: compiled expressions run with the query's operators
    try:
        comp = compile_pipeline_to_sql(pipe)
        times[1] = timed(Project(scan, [], dict(comp.exprs)))
    except MLtoSQLUnsupported:
        pass

    # dnn: tensor program in the engine's pure stage
    comp = compile_pipeline_tensor(pipe, device=dev)
    times[2] = timed(
        Project(TensorOp(scan, comp.fn, list(pipe.outputs)), list(pipe.outputs))
    )
    return times


def build_corpus(
    n_pipelines: int = 138, n_rows: int = 20_000, seed: int = 0,
    progress=None, device=None,
) -> Corpus:
    """Train ``n_pipelines`` pipelines from ``seed`` and measure each under
    every runtime on ``device`` (default the card; ``"cpu"`` when asked)."""
    rng = np.random.default_rng(seed)
    pipelines, stats, runtimes = [], [], []
    for i in range(n_pipelines):
        spec = _sample_pipeline_spec(rng)
        pipe = _train_one(spec, rng)
        pipelines.append(pipe)
        stats.append(pipeline_stats(pipe))
        runtimes.append(_measure(pipe, n_rows, rng, device=device))
        if progress:
            progress(i, n_pipelines, spec)
    stats = np.asarray(stats)
    runtimes = np.asarray(runtimes)
    labels = np.argmin(runtimes, axis=1)
    return Corpus(
        pipelines=pipelines, stats=stats, runtimes=runtimes, labels=labels
    )
