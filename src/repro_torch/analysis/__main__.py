"""``python -m repro_torch.analysis`` — the port's static-analysis CI gate.

Runs (1) the concurrency/forbidden-pattern lint over the port's sources
and (2) the plan verifier, in strict coverage, over a deterministic scenario
sweep that exercises every lowering path the optimizer can emit today:
MLtoSQL projection plans, fully-fused MLtoDNN TensorOps, split
``TensorOp → MLUdf → TensorOp`` chains with ``__pv_*`` block columns,
monolithic host MLUdfs (both fallback and cost-model-chosen), segmented
aggregates, and relational-kernel chains (filter→join→group-by with
min/max over a unique-key dim table), then (3) a model lifecycle and a
fault drill audited by :func:`~repro_torch.analysis.registry_check.check_registry`.
Everything runs on ``--device`` (the card unless ``--device cpu``): the
abstract runs, the sessions and their served queries, so on the card the
scenarios launch the port's kernels (``gather_join``, ``segment_agg``, and
``featurize`` where a plan fuses it). Exits nonzero on any violation,
printing each with its rule id. On the card it also prints the kernel
launches the scenarios made, as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.analysis.rules import AnalysisResult, Violation, rule_catalog


def _toy_pipeline(with_udf: bool = False):
    """A hand-built featurize+linear pipeline (no training: fixed weights,
    so the gate is deterministic and fast)."""
    from repro_torch.ml.pipeline import InputSpec, PipelineNode, TrainedPipeline

    nodes = [
        PipelineNode("concat", ["a", "b"], ["num_raw"], {}),
        PipelineNode(
            "scaler", ["num_raw"], ["num_scaled"],
            {
                "offset": np.array([0.1, -0.2]),
                "scale": np.array([1.5, 0.75]),
            },
        ),
        PipelineNode("concat", ["num_scaled"], ["features"], {}),
    ]
    feat = "features"
    if with_udf:
        def _bump(x):
            return x + 0.125

        _bump.__fingerprint_token__ = "analysis-cli-python-udf-v1"
        nodes.append(
            PipelineNode("python_udf", [feat], ["tweaked"], {"fn": _bump})
        )
        feat = "tweaked"
    nodes.append(
        PipelineNode(
            "linear", [feat], ["score", "label"],
            {
                "weights": np.array([0.8, -0.5]),
                "bias": 0.25,
                "post": "logistic",
            },
        )
    )
    return TrainedPipeline(
        inputs=[InputSpec("a", "numeric"), InputSpec("b", "numeric")],
        outputs=["score", "label"],
        nodes=nodes,
    )


def _scenarios():
    """(name, PredictionQuery, OptimizerOptions, tables) per lowering path."""
    from repro_torch.core.cost import CostModel
    from repro_torch.core.ir import (
        LAggregate,
        LFilter,
        LJoin,
        LPredict,
        LScan,
        PredictionQuery,
    )
    from repro_torch.core.optimizer import OptimizerOptions
    from repro_torch.relational.expr import Bin, Col, Const

    rng = np.random.default_rng(7)
    tables = {
        "t": {
            "a": rng.normal(size=32),
            "b": rng.normal(size=32),
            "k": rng.integers(0, 8, size=32).astype(np.int32),
        },
        # unique int keys + f32 payload: qualifies for the gather-join kernel
        "d": {
            "dk": np.arange(8, dtype=np.int32),
            "v1": (np.arange(8) * 0.25).astype(np.float32),
        },
    }

    def scan():
        return LScan("t", ["a", "b", "k"])

    def predict(child, with_udf=False):
        return LPredict(
            child, _toy_pipeline(with_udf), ["score", "label"]
        )

    def q(plan):
        return PredictionQuery(plan)

    def opts(transform):
        return OptimizerOptions(transform=transform, verify="off")

    yield ("mltosql", q(predict(scan())), opts("sql"), tables)
    yield ("mltodnn-full", q(predict(scan())), opts("dnn"), tables)
    yield ("mltodnn-split", q(predict(scan(), with_udf=True)),
           opts("dnn"), tables)
    yield ("host-udf", q(predict(scan())), opts("none"), tables)
    yield (
        "filtered-aggregate",
        q(LAggregate(
            LFilter(predict(scan()), Bin("gt", Col("score"), Const(0.5))),
            [("n", "count", ""), ("avg_score", "mean", "score")],
        )),
        opts("dnn"),
        tables,
    )
    # filter→join→group-by over the relational kernels (gather_join +
    # segment_agg): join brings an f32 payload off a unique-key dim table,
    # the filter folds into the aggregate mask, min/max exercise the
    # extremum lanes
    yield (
        "relational-kernels",
        q(LAggregate(
            LFilter(
                LJoin(scan(), "d", "k", "dk", ["v1"]),
                Bin("gt", Col("a"), Const(0.0)),
            ),
            [
                ("n", "count", ""), ("sum_v1", "sum", "v1"),
                ("min_v1", "min", "v1"), ("max_v1", "max", "v1"),
                ("avg_a", "mean", "a"),
            ],
        )),
        opts("none"),
        tables,
    )
    # join feeding a predict split: the kernel join fuses into the pure
    # prefix stage around the host residual
    yield (
        "join-predict-split",
        q(predict(LJoin(scan(), "d", "k", "dk", ["v1"]), with_udf=True)),
        opts("dnn"),
        tables,
    )
    # the cost model prices the split's boundary crossings above the tensor
    # speedup and collapses it to one monolithic host MLUdf
    cost_opts = OptimizerOptions(
        transform="dnn", verify="off",
        cost_model=CostModel(
            crossing_ns_per_row=1e7, segment_fixed_us=1e6
        ),
    )
    yield ("cost-monolithic", q(predict(scan(), with_udf=True)),
           cost_opts, tables)


def _verify_scenarios(device) -> AnalysisResult:
    from repro_torch.analysis.verifier import check_exec, check_graph, check_logical
    from repro_torch.core.optimizer import RavenOptimizer
    from repro_torch.exec.stages import build_stage_graph

    res = AnalysisResult()
    for name, query, opts, tables in _scenarios():
        vs = check_logical(query, where="input")
        plan, _report = RavenOptimizer(options=opts).optimize(query)
        graph = build_stage_graph(plan)
        vs += check_graph(graph)
        vs += check_exec(graph, tables, device=device)
        for v in vs:
            v.where = f"{name}: {v.where}" if v.where else name
        res.violations += vs
        if not vs:
            res.passed.append(
                f"scenario {name!r}: {len(graph.stages)} stage(s) verified "
                f"(logical+graph+exec)"
            )
    return res


def _verify_lifecycle(device) -> AnalysisResult:
    """Drive one publish → shadow → split → cutover lifecycle end-to-end
    and audit the recorded evidence with :func:`check_registry` — the
    registry rules need real state to replay, so the gate makes some."""
    from repro_torch.analysis.registry_check import check_registry
    from repro_torch.session import connect

    res = AnalysisResult()
    rng = np.random.default_rng(11)
    tables = {
        "t": {
            "a": rng.normal(size=64),
            "b": rng.normal(size=64),
            "k": rng.integers(0, 8, size=64).astype(np.int32),
        },
    }
    db = connect(tables, stats="auto", device=device)
    db.models.publish("gate", _toy_pipeline())
    prep = db.sql(
        "SELECT * FROM PREDICT(model='gate', data=t) AS p"
    ).prepare(transform="sql")
    prep.serve("gate_q")
    batch = {"a": rng.normal(size=16), "b": rng.normal(size=16),
             "k": rng.integers(0, 8, size=16).astype(np.int32)}
    prep.submit(batch)
    db.flush()

    db.models.publish("gate", _toy_pipeline(with_udf=True), warm="sync")
    db.models.shadow("gate", 2)
    prep.submit(batch)
    db.flush()
    db.models.split("gate", {2: 0.25})
    prep.submit(batch)
    db.flush()
    db.models.split("gate", {})
    db.models.cutover("gate", 2)
    prep.submit(batch)
    db.flush()
    db.models.retire("gate", 1)

    vs = check_registry(db)
    for v in vs:
        v.where = f"lifecycle: {v.where}" if v.where else "lifecycle"
    res.violations += vs
    if not vs:
        snap = db.models.snapshot()["gate"]
        states = [f"v{v['version']}={v['state']}" for v in snap["versions"]]
        res.passed.append(
            "lifecycle scenario: publish→shadow→split→cutover→retire "
            f"audited clean ({', '.join(states)})"
        )
    db.close()
    return res


def _verify_faultdrill(device) -> AnalysisResult:
    """Drive the fault-tolerance machinery end-to-end — transient faults
    retried through the scheduler, a policy-triggered rollback, and a
    journal round-trip recovered into a fresh session — and audit both
    sessions with :func:`check_registry` (which includes the retry-state /
    breaker-state / recovery-journal rules)."""
    import tempfile

    from repro_torch.analysis.registry_check import check_registry
    from repro_torch.exec.faults import FaultPlan, RetryPolicy, RollbackPolicy
    from repro_torch.options import ConnectOptions, ServeOptions
    from repro_torch.session import connect

    res = AnalysisResult()
    rng = np.random.default_rng(13)
    tables = {
        "t": {
            "a": rng.normal(size=64),
            "b": rng.normal(size=64),
            "k": rng.integers(0, 8, size=64).astype(np.int32),
        },
    }
    batch = {"a": rng.normal(size=16), "b": rng.normal(size=16),
             "k": rng.integers(0, 8, size=16).astype(np.int32)}
    plan = FaultPlan({"stage": {"times": 2}}, seed=3)
    with tempfile.TemporaryDirectory() as cache:
        db = connect(tables, stats="auto", device=device, options=ConnectOptions(
            cache_dir=cache, faults=plan,
        ))
        db.models.publish("gate", _toy_pipeline())
        prep = db.sql(
            "SELECT * FROM PREDICT(model='gate', data=t) AS p"
        ).prepare(transform="sql")
        prep.serve("gate_q", options=ServeOptions(
            retry=RetryPolicy(max_attempts=4, backoff_ms=0.25),
        ))
        for _ in range(3):
            req = prep.submit(batch)
            db.flush()
            req.wait(timeout=60.0)
        # v2 must pickle (the journal persists pipelines); the with_udf
        # variant closes over a local function, which pickle rejects —
        # exactly the fail-soft skip path, but not what this drill tests
        db.models.publish("gate", _toy_pipeline(), warm="sync")
        db.models.cutover("gate", 2)
        for _ in range(3):
            req = prep.submit(batch)
            db.flush()
            req.wait(timeout=60.0)
        restored = db.models.check_rollback("gate", RollbackPolicy(
            max_p99_ratio=1e-9, min_requests=1,
        ))
        vs = check_registry(db)
        retries = db.server.scheduler.retries
        if restored is None or restored.version != 1:
            vs.append(Violation(
                "recovery-journal",
                f"forced rollback policy did not restore v1 (got "
                f"{restored})", where="faultdrill",
            ))
        if not retries:
            vs.append(Violation(
                "retry-state",
                "injected transient stage faults produced no scheduler "
                "retries", where="faultdrill",
            ))
        db.close()

        db2 = connect(tables, stats="auto", device=device, options=ConnectOptions(
            cache_dir=cache,
        ))
        counts = db2.recover()
        if not counts.get("recovered") or counts.get("skipped"):
            vs.append(Violation(
                "recovery-journal",
                f"recover() did not restore the journaled topology: "
                f"{counts}", where="faultdrill",
            ))
        vs += check_registry(db2)
        db2.close()
    for v in vs:
        v.where = f"faultdrill: {v.where}" if v.where else "faultdrill"
    res.violations += vs
    if not vs:
        res.passed.append(
            f"faultdrill scenario: {retries} transient retries recovered, "
            f"rollback restored v1, journal recovered clean "
            f"({counts['routes']} route(s))"
        )
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Raven static analysis for the port: plan verifier + "
                    "concurrency lint",
    )
    ap.add_argument(
        "--lint-only", action="store_true",
        help="run only the source lint (skip plan verification)",
    )
    ap.add_argument(
        "--verify-only", action="store_true",
        help="run only the plan-verification sweep (skip the source lint)",
    )
    ap.add_argument(
        "--rules", action="store_true", help="print the rule catalog and exit",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the scenarios run (default: the card; cpu when asked)",
    )
    args = ap.parse_args(argv)

    if args.rules:
        for r in rule_catalog():
            print(f"{r.id:<28} {r.scope:<8} {r.description}")
        return 0

    result = AnalysisResult()
    if not args.verify_only:
        from repro_torch.analysis.concurrency import lint_repo

        result.extend(lint_repo())
    if not args.lint_only:
        from repro_torch.device import resolve_device

        device = resolve_device(args.device)
        result.extend(_verify_scenarios(device))
        result.extend(_verify_lifecycle(device))
        result.extend(_verify_faultdrill(device))
        if device.type == "cuda":
            from repro_torch.kernels._build import LAUNCHES

            print("kernel launches:", json.dumps(LAUNCHES))

    print(result.describe())
    if result.violations:
        print(
            f"\nanalysis FAILED: {len(result.violations)} violation(s)",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
