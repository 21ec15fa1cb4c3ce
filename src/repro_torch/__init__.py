"""PyTorch/CUDA port of the Raven prediction-query optimizer and engine.

A second package beside the JAX reference (``repro``), with the same
layout: ``ml`` (pipelines, training), ``data`` (datasets), ``core`` (IR,
rules, optimizer), ``sql`` (parser), ``relational`` (plans, engine),
``exec`` (stage graph), ``tensor`` (the MLtoDNN tensor compiler) and
``kernels`` (hand-written CUDA kernels for Hopper, with plain PyTorch
versions). It imports neither JAX nor the reference package, and runs on the
card unless the caller passes ``device="cpu"``::

    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
    from repro_torch.relational.engine import compile_plan, upload_database
    from repro_torch.sql.parser import parse_prediction_query

    q = parse_prediction_query(sql, {"m": pipe}, tables)
    plan, report = RavenOptimizer(options=OptimizerOptions(transform="dnn")).optimize(q)
    db = upload_database(tables)          # once
    out = compile_plan(plan).run(db, params={"t": 0.5}).table
"""
