"""PyTorch/CUDA port of the Raven prediction-query optimizer and engine.

A second package beside the JAX reference (``repro``), with the same
layout: ``ml`` (pipelines, training), ``data`` (datasets), ``core`` (IR,
rules, optimizer), ``sql`` (parser), ``relational`` (plans, engine),
``exec`` (stage graph, capture, scheduler, pipelined executor),
``tensor`` (the MLtoDNN tensor compiler),
``kernels`` (hand-written CUDA kernels for Hopper, with plain PyTorch
versions) and ``session`` (the front door). It imports neither JAX nor the
reference package, and runs on the card unless the caller passes
``device="cpu"``::

    import repro_torch as raven

    db = raven.connect(tables, stats="auto")       # tables to the card, once
    db.register_model("m", pipe)
    prep = db.sql(
        "SELECT COUNT(*), AVG(score) FROM PREDICT(model='m', data=patients) "
        "WHERE score >= :t"
    ).prepare(transform="dnn", params={"t": 0.5})   # or "sql"; default "none"
    print(prep.explain())
    out = prep()                 # one-shot: one CUDA graph replay a stage
    prep.bind(t=0.8)             # same plan, no new compile or capture
    prep.serve()                 # bucketed, micro-batched serving
    req = prep.submit(batch); db.flush()

Lower layers (``repro_torch.core``, ``repro_torch.sql``,
``repro_torch.relational``) remain importable directly.
"""
from repro_torch.errors import (
    FaultInjectedError,
    RavenError,
    RecoveryError,
    RegistryStateError,
    RequestFailedError,
    RequestTimeoutError,
    ServerOverloadedError,
    SQLSyntaxError,
    StaleQueryError,
    TransientError,
    TransientFaultError,
    UnboundParameterError,
    UnknownColumnError,
    UnknownModelError,
    UnknownModelVersionError,
    UnknownParameterError,
    UnknownQueryError,
    UnknownTableError,
)
from repro_torch.options import ConnectOptions, ServeOptions
from repro_torch.serve.registry import ModelRegistry, ModelVersion
from repro_torch.session import (
    PreparedQuery,
    Query,
    QueryBuilder,
    Session,
    connect,
)

# after repro_torch.session, as in the reference (the session import
# initializes the relational layer first)
from repro_torch.exec.faults import FaultPlan, RetryPolicy, RollbackPolicy  # noqa: E402

__all__ = [
    "connect",
    "Session",
    "Query",
    "QueryBuilder",
    "PreparedQuery",
    "RavenError",
    "SQLSyntaxError",
    "UnknownModelError",
    "UnknownTableError",
    "UnknownColumnError",
    "UnboundParameterError",
    "UnknownParameterError",
    "UnknownQueryError",
    "StaleQueryError",
    "ServerOverloadedError",
    "UnknownModelVersionError",
    "RegistryStateError",
    "ConnectOptions",
    "ServeOptions",
    "ModelRegistry",
    "ModelVersion",
    "FaultPlan",
    "RetryPolicy",
    "RollbackPolicy",
    "FaultInjectedError",
    "TransientError",
    "TransientFaultError",
    "RequestTimeoutError",
    "RequestFailedError",
    "RecoveryError",
]
