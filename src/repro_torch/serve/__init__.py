"""Serving: the continuous-batching LM engine and the prediction-query
server (bucketed, micro-batched, captured), with its scheduler and
pipelined executor."""
# the query server first: it initializes the relational layer before the
# executor's import of the stage graph (import cycle)
from repro_torch.serve.query_server import (
    PredictionQueryServer,
    QueryRequest,
    RegisteredQuery,
    ServerStats,
    row_bucket,
)
from repro_torch.exec.pipeline import PipelineExecutor  # noqa: E402
from repro_torch.exec.scheduler import RequestPump, Scheduler  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.registry import ModelRegistry, ModelVersion

__all__ = [
    "Request",
    "RequestPump",
    "PipelineExecutor",
    "Scheduler",
    "ServeEngine",
    "PredictionQueryServer",
    "QueryRequest",
    "RegisteredQuery",
    "ServerStats",
    "row_bucket",
    "ModelRegistry",
    "ModelVersion",
]
