"""Columnar PyTorch data engine: expressions, tables, physical plans.

ML pipelines enter a plan as a ``TensorOp`` (the MLtoDNN path): a fused
tensor program that runs in the same pure stage as the scans, joins,
filters and aggregates around it.
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
