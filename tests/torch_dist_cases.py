"""The multi-process cases of ``tests/test_torch_distributed.py``.

Two entry points, each run in processes of its own:

* ``python -m tests.torch_dist_cases reference DIR``: the reference
  package on 8 host devices (``XLA_FLAGS`` set by the caller before JAX
  starts): ``compile_plan_sharded``, ``hierarchical_psum``, the int8
  all-reduce, the vocab-sharded lookup under ``shard_map``, ``Model.loss``,
  ``prefill`` and ``decode`` with that lookup, ``moe_ffn`` and
  ``make_train_step`` on the whole batch; its results in ``DIR/ref.npz``;
* ``python -m tests.torch_dist_cases port WORLD RANK DIR``: one gloo rank of
  the port on the CPU, the group met through a file in ``DIR`` (no TCP
  port, so concurrent test workers cannot collide); every case of that
  world size, its results in ``DIR/port_WORLD_RANK.npz``. This side
  imports neither JAX nor ``repro``.

Both read the inputs the test wrote to ``DIR`` (the hospital table, the
trained pipeline, the reference's random draws and initial weights) and
make the rest from numpy seeds here.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

HOSPITAL_QUERIES = {
    "sums": "SELECT COUNT(*), SUM(score) FROM PREDICT(model='m', data=patients) AS p "
            "WHERE score >= 0.5",
    "extremes": "SELECT MIN(score), MAX(score) FROM PREDICT(model='m', data=patients) AS p "
                "WHERE score > 0.05",
}
TRANSFORMS = ("sql", "dnn")
FACT_ROWS, DIM_ROWS, WORLD = 2048, 256, 8
EMPTY_SHARD, NAN_SHARD = 5, 3  # star schema: a shard with no row past the filter, one with a NaN
STAR_AGGS = [("n", "count", "x"), ("sum_x", "sum", "x"), ("sum_v0", "sum", "v0"),
             ("min_x", "min", "x"), ("max_x", "max", "x"), ("min_v1", "min", "v1"),
             ("max_v1", "max", "v1"), ("min_w", "min", "w"), ("max_w", "max", "w")]
ARCHS = ("qwen2-0.5b", "qwen2-moe-a2.7b")  # the data-parallel step, at the configs' own settings
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 40, 1e-3
MESH_ARCHS = ("qwen2-0.5b", "whisper-small")  # Model.* with the vocab-sharded lookup
SERVE_BATCH, SERVE_SEQ, SERVE_CACHE = 4, 10, 12
# moe_ffn over 2 data ranks: 4 rows of 24 positions in blocks of 16 tokens
# (4 positions of the whole batch, 8 of one rank's 2 rows)
MOE_ARCH, MOE_ROWS, MOE_SEQ, MOE_BLOCK = "qwen2-moe-a2.7b", 4, 24, 16
PARAM_ARCHS = tuple(dict.fromkeys(ARCHS + MESH_ARCHS))


def star_tables(nan: bool = False) -> dict:
    """A star schema with dyadic measures (float32 sums exact in any
    order): the fact's rows of shard ``EMPTY_SHARD`` (of 8) all fail
    ``x > 0``; with ``nan``, one row of shard ``NAN_SHARD`` that passes it
    has a NaN ``w``. A fifth of the fact keys miss the dim table."""
    rng = np.random.default_rng(11)

    def dy(n):
        return (rng.integers(-40, 40, size=n) * 0.25).astype(np.float32)

    dim = {"k": np.arange(DIM_ROWS, dtype=np.int64), "v0": dy(DIM_ROWS), "v1": dy(DIM_ROWS)}
    fact = {"fk": rng.integers(0, DIM_ROWS + DIM_ROWS // 4, size=FACT_ROWS).astype(np.int64),
            "x": dy(FACT_ROWS), "w": dy(FACT_ROWS)}
    per = FACT_ROWS // WORLD
    fact["x"][EMPTY_SHARD * per:(EMPTY_SHARD + 1) * per] = -np.abs(
        fact["x"][EMPTY_SHARD * per:(EMPTY_SHARD + 1) * per])
    if nan:
        row = NAN_SHARD * per + 7
        fact["x"][row], fact["fk"][row], fact["w"][row] = 1.0, 3, np.nan
    return {"f": fact, "d": dim}


def star_plan(E, X, aggregate: bool):
    """fact ⋈ dim, ``x > 0``, then the ``STAR_AGGS`` or (without
    ``aggregate``) the joined rows; ``E`` and ``X`` are a package's
    ``relational.engine`` and ``relational.expr``."""
    rows = E.Filter(E.Join(E.Scan("f", ["fk", "x", "w"]), "d", "fk", "k", ["v0", "v1"]),
                    X.Bin("gt", X.Col("x"), X.Const(0.0)))
    return E.Aggregate(rows, list(STAR_AGGS)) if aggregate else rows


def lm_batch(cfg) -> dict:
    """Tokens and labels; labels below 0 only in the first half of the
    batch, so two data ranks hold different counts of them."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)
    labels[: TRAIN_BATCH // 2, :7] = -1
    return {"tokens": tokens, "labels": labels}


def train_config(reduced_config, arch: str):
    return reduced_config(arch, dtype="float32")


def serve_batch(cfg) -> dict:
    """A prompt (with its labels for the loss, and frames for the enc-dec)
    and the next tokens for one decode step."""
    rng = np.random.default_rng(9)
    out = {k: rng.integers(0, cfg.vocab_size, (SERVE_BATCH, SERVE_SEQ)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.frontend == "audio":
        out["frames"] = (rng.normal(size=(SERVE_BATCH, cfg.frontend_tokens, cfg.d_model))
                         * 0.5).astype(np.float32)
    out["next"] = rng.integers(0, cfg.vocab_size, SERVE_BATCH).astype(np.int32)
    return out


def moe_inputs(cfg, shapes: dict) -> tuple[dict, np.ndarray, object]:
    """Seeded weights and a (MOE_ROWS, MOE_SEQ, D) input where column 0 of
    the router reads feature 0, which three tokens in four hold large: the
    first expert is asked for more than its capacity in every block, so
    the assignments past it, on the second rank's rows, are dropped. Also
    the config with room for every assignment."""
    rng = np.random.default_rng(3)
    w = {k: (rng.normal(size=s) * (0.5 if k == "router_col" else 1 / np.sqrt(s[-2])))
         .astype(np.float32) for k, s in sorted(shapes.items())}
    w["router_col"][0, 0] = 40.0
    x = rng.normal(size=(MOE_ROWS, MOE_SEQ, cfg.d_model)).astype(np.float32)
    x[..., 0] = np.where(rng.random((MOE_ROWS, MOE_SEQ)) < 0.75, 3.0, -3.0)
    return w, x, dataclasses.replace(cfg, moe_capacity_factor=100.0)


def flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def nest(flat_tree: dict) -> dict:
    out: dict = {}
    for path, v in flat_tree.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _hier_inputs() -> dict:
    """``tests/test_distributed.py``'s ``x`` and a leaf whose rows (3) the
    intra axis (4) does not divide."""
    return {"x": np.arange(32, dtype=np.float32).reshape(8, 4),
            "y": np.arange(24, dtype=np.float32).reshape(8, 3) * 0.5}


# ---------------------------------------------------------------------------
# The reference, on 8 host devices
# ---------------------------------------------------------------------------


def _jparams(jax, jnp, inp: dict, arch: str) -> dict:
    return jax.tree.map(jnp.asarray, nest({k[len(arch) + 1:]: v for k, v in inp.items()
                                           if k.startswith(arch + "/")}))


def reference(d: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.configs import reduced_config
    from repro.core.optimizer import OptimizerOptions, RavenOptimizer
    from repro.distributed import compressed_gradient_update, ef_init, hierarchical_psum
    from repro.ml.pipeline import load_pipeline
    from repro.models import build_model
    from repro.models.moe import moe_ffn, moe_param_shapes
    from repro.models.transformer import embed_lookup
    from repro.relational import engine as E
    from repro.relational import expr as X
    from repro.sql.parser import parse_prediction_query
    from repro.train.step import init_opt_state, make_train_step

    assert len(jax.devices()) == WORLD
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    out: dict[str, np.ndarray] = {}
    pipe = load_pipeline(os.path.join(d, "m.npz"))
    db = {"patients": dict(np.load(os.path.join(d, "patients.npz")))}
    mesh = jax.make_mesh((WORLD,), ("data",))
    for tf in TRANSFORMS:
        for name, sql in HOSPITAL_QUERIES.items():
            plan, _ = RavenOptimizer(options=OptimizerOptions(transform=tf)).optimize(
                parse_prediction_query(sql, {"m": pipe}, db))
            sharded = E.compile_plan_sharded(plan, mesh, fact_table="patients")(db)
            whole = E.execute_plan(plan, db)
            for k, v in sharded.columns.items():
                out[f"hosp/{tf}/{name}/sharded/{k}"] = np.asarray(v)
                out[f"hosp/{tf}/{name}/whole/{k}"] = np.asarray(whole.columns[k])
    for nan in (False, True):
        tables = star_tables(nan)
        tag = "star_nan" if nan else "star"
        agg = star_plan(E, X, True)
        sharded = E.compile_plan_sharded(agg, mesh, fact_table="f")(tables)
        whole = E.execute_plan(agg, tables)
        for k, v in sharded.columns.items():
            out[f"{tag}/sharded/{k}"] = np.asarray(v)
            out[f"{tag}/whole/{k}"] = np.asarray(whole.columns[k])
    rows = E.compile_plan_sharded(star_plan(E, X, False), mesh, fact_table="f")(star_tables())
    for k, v in rows.columns.items():
        out[f"star_rows/{k}"] = np.asarray(v)
    out["star_rows/__valid__"] = np.asarray(rows.valid)

    # the two-level reduction on (pod 2, data 4), beside one flat psum
    mesh2 = jax.make_mesh((2, 4), ("pod", "data"))
    spec = P(("pod", "data"), None)
    tree = {k: jnp.asarray(v) for k, v in _hier_inputs().items()}
    specs = {k: spec for k in tree}
    hier = shard_map(lambda t: hierarchical_psum(t, intra_axis="data", inter_axis="pod"),
                     mesh=mesh2, in_specs=(specs,), out_specs=specs)(tree)
    flat_sum = shard_map(lambda t: jax.tree.map(lambda v: jax.lax.psum(v, ("pod", "data")), t),
                         mesh=mesh2, in_specs=(specs,), out_specs=specs)(tree)
    for k in tree:
        out[f"hier/{k}"] = np.asarray(hier[k])
        out[f"hier_flat/{k}"] = np.asarray(flat_sum[k])

    # the int8 all-reduce over (pod 4,): the output and the new residual
    mesh4 = jax.make_mesh((4,), ("pod",))

    def body(gl):
        res, state = compressed_gradient_update({"g": gl}, ef_init({"g": gl}), axis_name="pod")
        return res["g"], state.residual["g"]

    got, res = shard_map(body, mesh=mesh4, in_specs=P("pod", None),
                         out_specs=(P("pod", None), P("pod", None)))(jnp.asarray(inp["g"]))
    out["compressed/out"], out["compressed/residual"] = np.asarray(got), np.asarray(res)

    # the vocab-sharded lookup on (data 2, model 4), B = 4 and B = 1
    mesh_dm = jax.make_mesh((2, 4), ("data", "model"))
    embed, toks = jnp.asarray(inp["embed"]), jnp.asarray(inp["toks"])
    with mesh_dm:
        out["embed/b4"] = np.asarray(embed_lookup(embed, toks, mesh_dm))
        out["embed/b1"] = np.asarray(embed_lookup(embed, toks[:1], mesh_dm))

    # Model.loss, prefill and one decode step with the lookup on (data 2,
    # model 4). jax.make_mesh's axes are Explicit here, and the zoo's
    # attention reshape refuses a batch sharded on them ("Splitting on more
    # than 1 axis is not supported"): the zoo runs jitted on Auto axes
    auto = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for arch in MESH_ARCHS:
        cfg = train_config(reduced_config, arch)
        model = build_model(cfg)
        params = _jparams(jax, jnp, inp, arch)
        sb = {k: jnp.asarray(v) for k, v in serve_batch(cfg).items()}
        step = {"tokens": sb["next"], "lengths": jnp.full((SERVE_BATCH,), SERVE_SEQ, jnp.int32)}
        with auto:
            out[f"serve/{arch}/loss"] = np.asarray(
                jax.jit(lambda p, b: model.loss(p, b, mesh=auto))(params, sb))
            logits, caches = jax.jit(lambda p, b: model.prefill(
                p, b, mesh=auto, cache_len=SERVE_CACHE))(params, sb)
            out[f"serve/{arch}/prefill/logits"] = np.asarray(logits)
            for i, c in enumerate(caches):
                out[f"serve/{arch}/prefill/cache{i}"] = np.asarray(c)
            logits, caches = jax.jit(lambda p, s, c: model.decode(p, s, c, mesh=auto))(
                params, step, caches)
        out[f"serve/{arch}/decode/logits"] = np.asarray(logits)
        for i, c in enumerate(caches):
            out[f"serve/{arch}/decode/cache{i}"] = np.asarray(c)

    # moe_ffn on the whole batch, at the config's capacity and with room for all
    mcfg = train_config(reduced_config, MOE_ARCH)
    w, x, roomy = moe_inputs(mcfg, moe_param_shapes(mcfg))
    for dispatch in ("einsum", "scatter"):
        for tag, c in (("", mcfg), ("_roomy", roomy)):
            out[f"moe{tag}/{dispatch}"] = np.asarray(moe_ffn(
                {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
                dataclasses.replace(c, moe_dispatch=dispatch), token_block=MOE_BLOCK))

    # one train step on the whole batch
    for arch in ARCHS:
        cfg = train_config(reduced_config, arch)
        model = build_model(cfg)
        params = _jparams(jax, jnp, inp, arch)
        opt = init_opt_state(model, params)
        step = jax.jit(make_train_step(model, lr=TRAIN_LR))
        batch = {k: jnp.asarray(v) for k, v in lm_batch(cfg).items()}
        params, opt, metrics = step(params, opt, batch)
        out[f"train/{arch}/loss"] = np.asarray(metrics["loss"])
        out[f"train/{arch}/grad_norm"] = np.asarray(metrics["grad_norm"])
        for part, tree in (("params", params), ("m", opt["m"])):
            for k, v in flat(jax.tree.map(np.asarray, tree)).items():
                out[f"train/{arch}/{part}/{k}"] = v
    np.savez(os.path.join(d, "ref.npz"), **out)


# ---------------------------------------------------------------------------
# The port: one gloo rank
# ---------------------------------------------------------------------------


def _hospital_plans(d: str):
    from repro_torch.core.optimizer import OptimizerOptions, RavenOptimizer
    from repro_torch.ml.pipeline import load_pipeline
    from repro_torch.sql.parser import parse_prediction_query

    pipe = load_pipeline(os.path.join(d, "m.npz"))
    db = {"patients": dict(np.load(os.path.join(d, "patients.npz")))}
    for tf in TRANSFORMS:
        for name, sql in HOSPITAL_QUERIES.items():
            plan, _ = RavenOptimizer(options=OptimizerOptions(transform=tf)).optimize(
                parse_prediction_query(sql, {"m": pipe}, db))
            yield tf, name, plan, db


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _world8(rank: int, d: str) -> dict:
    import torch

    from repro_torch.distributed import hierarchical_psum
    from repro_torch.launch.mesh import make_local_mesh, make_mesh, make_production_mesh
    from repro_torch.models.transformer import embed_lookup
    from repro_torch.relational import engine as E
    from repro_torch.relational import expr as X

    out: dict[str, np.ndarray] = {}
    mesh = make_local_mesh(device="cpu")  # (data 8, model 1)
    for tf, name, plan, db in _hospital_plans(d):
        sharded = E.compile_plan_sharded(plan, mesh, "patients")(db)
        whole = E.compile_plan(plan)(db, device="cpu")
        for k, v in sharded.columns.items():
            out[f"hosp/{tf}/{name}/sharded/{k}"] = v.numpy()
            out[f"hosp/{tf}/{name}/whole/{k}"] = whole.columns[k].numpy()
        if (tf, name) == ("sql", "sums"):
            short = {"patients": {c: v[:-1] for c, v in db["patients"].items()}}
            out["refused/rows"] = np.array(_error(
                lambda: E.compile_plan_sharded(plan, mesh, "patients")(short)))
    for nan in (False, True):
        tables = star_tables(nan)
        tag = "star_nan" if nan else "star"
        agg = star_plan(E, X, True)
        sharded = E.compile_plan_sharded(agg, mesh, "f")(tables)
        whole = E.compile_plan(agg)(tables, device="cpu")
        for k, v in sharded.columns.items():
            out[f"{tag}/sharded/{k}"] = v.numpy()
            out[f"{tag}/whole/{k}"] = whole.columns[k].numpy()
    rows = E.compile_plan_sharded(star_plan(E, X, False), mesh, "f")(star_tables())
    for k, v in rows.columns.items():
        out[f"star_rows/{k}"] = v.numpy()
    out["star_rows/__valid__"] = rows.valid.numpy()

    pod_data = make_mesh((2, 4), ("pod", "data"), "cpu")
    tree = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in _hier_inputs().items()}
    hier = hierarchical_psum(tree, pod_data, "data", "pod")
    flat_sum = {k: v.clone() for k, v in tree.items()}
    for v in flat_sum.values():
        torch.distributed.all_reduce(v)
    for k in tree:
        out[f"hier/{k}"], out[f"hier_flat/{k}"] = hier[k].numpy(), flat_sum[k].numpy()
    out["hier/no_intra_axis"] = np.array(
        hierarchical_psum(tree, pod_data, intra_axis="model") is tree)

    inp = np.load(os.path.join(d, "inputs.npz"))
    embed, toks = torch.from_numpy(inp["embed"]), torch.from_numpy(inp["toks"])
    data_model = make_mesh((2, 4), ("data", "model"), "cpu")
    out["embed/b4"] = embed_lookup(embed, toks, data_model).numpy()
    out["embed/b1"] = embed_lookup(embed, toks[:1], data_model).numpy()
    with torch.enable_grad():
        out["refused/embed_grad"] = np.array(_error(
            lambda: embed_lookup(embed.clone().requires_grad_(True), toks, data_model)))
    out["refused/production"] = np.array(_error(lambda: make_production_mesh(device="cpu")))

    for arch in MESH_ARCHS:
        model, params = _port_model(inp, arch)
        sb = {k: torch.from_numpy(v) for k, v in serve_batch(model.cfg).items()}
        step = {"tokens": sb["next"], "lengths": torch.full((SERVE_BATCH,), SERVE_SEQ,
                                                            dtype=torch.int32)}
        for tag, m in (("mesh", data_model), ("none", None)):
            with torch.no_grad():
                out[f"serve/{arch}/{tag}/loss"] = model.loss(params, sb, m).numpy()
            logits, caches = model.prefill(params, sb, SERVE_CACHE, mesh=m)
            out[f"serve/{arch}/{tag}/prefill/logits"] = logits.numpy()
            for i, c in enumerate(caches):
                out[f"serve/{arch}/{tag}/prefill/cache{i}"] = c.numpy().copy()
            logits, caches = model.decode(params, step, caches, m)
            out[f"serve/{arch}/{tag}/decode/logits"] = logits.numpy()
            for i, c in enumerate(caches):
                out[f"serve/{arch}/{tag}/decode/cache{i}"] = c.numpy()
    return out


def _port_model(inp, arch: str):
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_jax

    model = build_model(train_config(reduced_config, arch))
    return model, params_from_jax(nest({k[len(arch) + 1:]: inp[k] for k in inp.files
                                        if k.startswith(arch + "/")}), device="cpu")


def _world4(rank: int, d: str) -> dict:
    import torch

    from repro_torch.distributed import compressed_gradient_update, ef_init
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((4,), ("pod",), "cpu")
    g = torch.from_numpy(np.load(os.path.join(d, "inputs.npz"))["g"][rank:rank + 1])
    res, state = compressed_gradient_update({"g": g}, ef_init({"g": g}), axis_name="pod",
                                            mesh=mesh)
    return {"compressed/out": res["g"].numpy(), "compressed/residual": state.residual["g"].numpy()}


def _train(d: str, mesh) -> dict:
    """One step of each arch from the reference's initial weights on the
    whole batch, through ``make_train_step(model, mesh)``; for the moe, the
    (token, k) assignments this rank's layers dropped in the step."""
    import torch

    from repro_torch.models import moe
    from repro_torch.train.step import init_opt_state, make_train_step

    inp = np.load(os.path.join(d, "inputs.npz"))
    out = {}
    route, dropped = moe._route, []

    def counted(*args):
        got = route(*args)
        dropped.append(int((~got[3]).sum()))
        return got

    for arch in ARCHS:
        model, params = _port_model(inp, arch)
        opt = init_opt_state(model, params)
        batch = {k: torch.from_numpy(v) for k, v in lm_batch(model.cfg).items()}
        moe._route, dropped[:] = counted, []
        try:
            params, opt, metrics = make_train_step(model, mesh, lr=TRAIN_LR)(params, opt, batch)
        finally:
            moe._route = route
        if model.cfg.family == "moe":
            out[f"dropped/{arch}"] = np.array(sum(dropped))
        out[f"train/{arch}/loss"] = metrics["loss"].numpy()
        out[f"train/{arch}/grad_norm"] = metrics["grad_norm"].numpy()
        for part, tree in (("params", params), ("m", opt["m"])):
            for k, v in flat(tree).items():
                out[f"train/{arch}/{part}/{k}"] = v.numpy()
    return out


def _world2(rank: int, d: str) -> dict:
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.moe import moe_ffn, moe_param_shapes, sharded_batch

    mesh = make_local_mesh(device="cpu")
    out = _train(d, mesh)
    cfg = train_config(reduced_config, MOE_ARCH)
    w, x, _ = moe_inputs(cfg, moe_param_shapes(cfg))
    w = {k: torch.from_numpy(v) for k, v in w.items()}
    rows = MOE_ROWS // 2
    mine = torch.from_numpy(x[rank * rows:(rank + 1) * rows])
    for dispatch in ("einsum", "scatter"):
        c = dataclasses.replace(cfg, moe_dispatch=dispatch)
        with sharded_batch(mesh, MOE_ROWS):
            out[f"moe/{dispatch}"] = moe_ffn(w, mine, c, token_block=MOE_BLOCK).numpy()
        out[f"moe_alone/{dispatch}"] = moe_ffn(w, mine, c, token_block=MOE_BLOCK).numpy()
    with sharded_batch(mesh, MOE_ROWS + 2):
        out["refused/moe_rows"] = np.array(_error(
            lambda: moe_ffn(w, mine, cfg, token_block=MOE_BLOCK)))
    return out


def _world1(rank: int, d: str) -> dict:
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

    meshed = _train(d, make_local_mesh(device="cpu"))
    out = {k.replace("train/", "train_mesh/"): v for k, v in meshed.items()}
    out.update(_train(d, None))
    out["refused/production"] = np.array(_error(
        lambda: make_production_mesh(multi_pod=True, device="cpu")))
    return out


CASES = {8: _world8, 4: _world4, 2: _world2, 1: _world1}


def port(world: int, rank: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, f'rdv_{world}')}",
                            rank=rank, world_size=world)
    try:
        out = CASES[world](rank, d)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(d, f"port_{world}_{rank}.npz"), **out)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        reference(sys.argv[2])
    else:
        port(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
