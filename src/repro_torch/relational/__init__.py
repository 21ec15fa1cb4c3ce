"""Columnar PyTorch data engine: expressions, tables, physical plans.

ML pipelines enter a plan in one of three physical forms (paper §5):

  * ``MLUdf``     — host boundary + interpreted numpy execution (the
                    Spark→Python-UDF→ONNX-Runtime path),
  * ``TensorOp``  — a fused tensor program that runs in the same pure stage
                    as the scans, joins, filters and aggregates around it
                    (the MLtoDNN path),
  * plain ``Project`` expressions — the MLtoSQL path (the model compiled
                    *into* the relational program).
"""
from repro_torch.relational.expr import (
    Bin,
    Case,
    Col,
    Const,
    Expr,
    Param,
    Un,
    eval_expr,
    expr_size,
)
from repro_torch.relational.table import Table
from repro_torch.relational.engine import (
    Aggregate,
    CompiledPlan,
    Database,
    Filter,
    Join,
    MLUdf,
    PhysicalPlan,
    PLAN_CACHE_STATS,
    Project,
    Scan,
    TensorOp,
    clear_plan_cache,
    compile_plan,
    execute_plan,
    plan_fingerprint,
    upload_database,
)
