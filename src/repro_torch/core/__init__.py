"""Raven's contribution: the unified IR and the prediction-query optimizer."""
from repro_torch.core.ir import (
    ColumnStats,
    LAggregate,
    LFilter,
    LJoin,
    LPredict,
    LProject,
    LScan,
    LogicalPlan,
    PredictionQuery,
    TableStats,
    plan_fingerprint,
    walk,
)
from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
