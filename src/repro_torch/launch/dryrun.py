"""Multi-pod dry run: trace every (arch × shape) cell on the production mesh
and record memory, cost and collective traffic per rank.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k [--multi-pod] [--device cpu] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --summary [--out DIR]

The reference forces 512 host devices, lowers and compiles each step with
its parameters, optimizer state and batch placed by the sharding rules, and
reads the compiler's memory and cost analyses. The port has no compiler. A
cell here initializes a ``"fake"`` process group of 256 ranks (512 with
``--multi-pod``) in one process, at rank 0: every other rank is fictitious
and every collective moves nothing. It builds the production mesh over
that group (on the card's device type unless ``--device cpu``), lays out
fake tensors (``FakeTensorMode``: shapes and dtypes, no memory) as DTensors
by ``shardings_for`` and ``batch_shardings``, and runs the train, prefill
or serve step on them: DTensor's sharding propagation inserts the
collectives, as XLA's SPMD partitioner does. :class:`~repro_torch.launch.
hlo_analysis.CostMode` counts what rank 0 executes. A train cell whose
config accumulates gradients traces one microbatch and scales it by
``accum_steps`` (the reference scales a loop body by its trip count); the
record says so (``accum_scaled``). Each ``--all`` cell runs in a fresh
subprocess.

The record has the reference's keys where the quantity exists, per rank:
``arg_bytes`` (parameters, optimizer state, batch, caches), ``alias_bytes``
(what the step updates in place: the reference's donated buffers),
``out_bytes``, ``temp_bytes`` (the most bytes of storages made by the step
alive at once, its accumulators included; ``peak_bytes`` adds the
arguments), ``exec_flops`` (and
``exec_flops_by_op``),
``exec_bytes``, ``exec_collective_bytes`` (executed, scaled by
``accum_steps``), ``collective_bytes`` (the traced program's, unscaled),
``unknown_trip_loops`` (always 0), and the config's ``model_flops``,
``n_params``, ``n_active_params`` and ``n_tokens``; ``trace_s`` stands for
``lower_s``/``compile_s``. ``hlo_flops``, ``hlo_bytes`` and ``code_bytes``
have no counterpart. Families whose layers do not run on sharded
parameters yet are ``refused``, with the ROADMAP item that brings them; an
unsupported shape is ``skipped``, as in the reference.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.hlo_analysis import COLLECTIVES, Cost, CostMode
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.shardings import batch_shardings
from repro_torch.models import build_model
from repro_torch.models.base import (
    SHAPES,
    Sharding,
    active_param_count,
    from_local,
    param_count,
    shardings_for,
    struct,
)
from repro_torch.models.zoo import SHARDED_FAMILIES, SHARDED_TODO, cache_names
from repro_torch.train.optimizer import adamw_update, adafactor_update, tree_leaves, tree_map

DEFAULT_OUT = os.path.join("build", "dryrun")


@contextlib.contextmanager
def fake_group(world: int):
    """A ``"fake"`` default process group of ``world`` ranks at rank 0, for
    the block (one already initialized is used as it is)."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def place_fake(tree, shardings, device):
    """Each leaf of ``tree`` (tensors without storage) as a DTensor laid out
    by its :class:`Sharding`, its local shard a new tensor on ``device``
    (fake under ``FakeTensorMode``)."""
    def one(t, sh: Sharding):
        local = torch.empty(sh.shard_shape(t.shape), dtype=t.dtype, device=device)
        return from_local(local, sh.mesh, sh.placements, t.shape)

    return tree_map(one, tree, shardings)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of a tree of (D)Tensors."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in tree_leaves(tree) if isinstance(tree, dict) else list(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def _train(model, params, opt, batch, cfg, sp) -> tuple[Cost, Cost, dict]:
    """One microbatch's gradients (under its own mode, to be scaled by
    ``accum_steps``) and the update with the gradient norms; the bytes of
    the accumulators alive across them."""
    from repro_torch.models import layers as L
    from repro_torch.train.step import loss_and_grads, microbatch

    A = cfg.accum_steps
    mb = microbatch(batch, 0, sp.global_batch // A) if A > 1 else batch
    acc_dt = torch.bfloat16 if cfg.optimizer_dtype == "bfloat16" else torch.float32
    update = adamw_update if cfg.optimizer == "adamw" else adafactor_update
    with L.replicate_plain():
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt), params) if A > 1 else None
        with CostMode() as micro:
            _, grads = loss_and_grads(model.loss, params, mb, scale=1.0 / A)
            if acc is not None:
                tree_map(lambda a, g: a.add_(g.to(acc_dt)), acc, grads)
                del grads
                grads = acc
        with CostMode() as upd:
            update(grads, opt, params, lr=3e-4)
            for g in tree_leaves(grads):
                sq = torch.sum(torch.square(g.float()))
                sq.full_tensor()
    extra = {"acc_bytes": local_bytes(acc) if acc is not None else 0}
    return micro.cost, upd.cost, extra


def trace_cell(arch: str, shape_name: str, multi_pod: bool = False, device=None, *,
               cfg=None, sp=None, mesh_shape: tuple[int, int] | None = None) -> dict:
    """The record of one cell (see the module's docstring). ``cfg``, ``sp``
    and a ``(data, model)`` ``mesh_shape`` (a group of that many fake
    ranks) stand in for the arch's config, the shape and the production
    mesh: a cut-down cell, in the tests and beside a real step."""
    cfg = cfg or get_config(arch)
    sp = sp or SHAPES[shape_name]
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape
                 else "2x16x16" if multi_pod else "16x16")
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": sp.kind}
    ok, why = cfg.supports_shape(shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    if cfg.family not in SHARDED_FAMILIES:
        rec.update(status="refused", reason=f"{cfg.family} on sharded parameters: "
                                            f"{SHARDED_TODO[cfg.family]}")
        return rec
    from torch._subclasses.fake_tensor import FakeTensorMode

    world = math.prod(mesh_shape) if mesh_shape else 512 if multi_pod else 256
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    with fake_group(world):
        mesh = (make_mesh(mesh_shape, ("data", "model"), device) if mesh_shape
                else make_production_mesh(multi_pod=multi_pod, device=device))
        dev = mesh.device_type
        model = build_model(cfg)
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            shapes = _struct_tree(model.shapes, dt)
            params = place_fake(shapes, shardings_for(shapes, mesh), dev)
            specs = model.input_specs(sp)
            batch = place_fake(specs, batch_shardings(specs, mesh), dev)
            if sp.kind == "train":
                from repro_torch.train.step import init_opt_state

                opt_s = init_opt_state(model, shapes, materialize=False)
                opt = place_fake(opt_s, shardings_for(opt_s, mesh), dev)
                micro, upd, extra = _train(model, params, opt, batch, cfg, sp)
                cost = Cost()
                cost.add(micro, cfg.accum_steps)
                cost.add(upd)
                once = Cost()
                once.add(micro)
                once.add(upd)
                args = local_bytes(params) + local_bytes(opt) + local_bytes(batch)
                alias = local_bytes(params) + local_bytes(opt)
                out_b = alias + 8  # the loss and the gradient norm, float32
                temp = max(micro.peak_bytes + extra["acc_bytes"], upd.peak_bytes)
                rec["accum_scaled"] = cfg.accum_steps
            elif sp.kind == "prefill":
                from repro_torch.train.step import make_prefill_step

                with torch.no_grad(), CostMode() as mode:
                    logits, caches = make_prefill_step(model)(params, batch)
                cost = once = mode.cost
                args = local_bytes(params) + local_bytes(batch)
                alias = 0
                out_b = local_bytes([logits, *caches])
                temp = mode.cost.peak_bytes
            else:
                from repro_torch.train.step import make_serve_step

                caches = tuple(batch[n] for n in cache_names(cfg))
                small = {k: batch[k] for k in ("tokens", "lengths")}
                with torch.no_grad(), CostMode() as mode:
                    nxt, logits, caches = make_serve_step(model)(params, small, caches)
                cost = once = mode.cost
                args = local_bytes(params) + local_bytes(batch)
                alias = local_bytes(list(caches))
                out_b = local_bytes([nxt, logits]) + alias
                temp = mode.cost.peak_bytes
        trace_s = time.time() - t0
    n_tokens = sp.global_batch * (sp.seq_len if sp.kind != "decode" else 1)
    n_params, n_active = param_count(cfg), active_param_count(cfg)
    mult = {"train": 6, "prefill": 2, "decode": 2}[sp.kind]
    rec.update(
        status="ok",
        trace_s=round(trace_s, 1),
        world=world,
        device=dev,
        arg_bytes=int(args),
        alias_bytes=int(alias),
        out_bytes=int(out_b),
        temp_bytes=int(temp),
        peak_bytes=int(args + temp),
        exec_flops=float(cost.flops),
        exec_flops_by_op={k: float(v) for k, v in sorted(cost.flops_by_op.items())},
        exec_bytes=float(cost.bytes),
        exec_collective_bytes={k: float(v) for k, v in cost.collective_bytes.items()},
        unknown_trip_loops=int(cost.unknown_trip_loops),
        collective_bytes={k: float(v) for k, v in once.collective_bytes.items()},
        model_flops=float(mult * n_active * n_tokens),
        n_params=n_params,
        n_active_params=n_active,
        n_tokens=n_tokens,
    )
    return rec


def _struct_tree(shapes: dict, dtype) -> dict:
    return {k: _struct_tree(v, dtype) if isinstance(v, dict) else struct(v, dtype)
            for k, v in shapes.items()}


def _summary(rec: dict) -> str:
    if rec["status"] != "ok":
        return f"{rec['status']} {rec.get('reason', '')}"
    return (f"ok arg={rec['arg_bytes'] / 2**30:.2f}GiB temp={rec['temp_bytes'] / 2**30:.2f}GiB "
            f"flops={rec['exec_flops']:.3e} trace={rec['trace_s']}s")


def summary(out: str, tag: str = "sp") -> str:
    """A markdown table of the ``ok`` records in ``out``, per rank: bytes
    in GiB, executed FLOPs, executed collective bytes by kind, the traced
    microbatches' scale and ``trace_s``; then every status counted."""
    import glob

    head = ("| arch | shape | arg GiB | temp GiB | peak GiB | exec_flops | "
            + " | ".join(f"{k} GiB" for k in COLLECTIVES[:4]) + " | accum | trace_s |")
    lines, counts = [head, "|---" * (head.count("|") - 1) + "|"], {}
    for path in sorted(glob.glob(os.path.join(out, f"dryrun_{tag}_*.json"))):
        with open(path) as f:
            r = json.load(f)
        counts[r["status"]] = counts.get(r["status"], 0) + 1
        if r["status"] != "ok":
            continue
        gib = [r[k] / 2**30 for k in ("arg_bytes", "temp_bytes", "peak_bytes")]
        coll = [r["exec_collective_bytes"].get(k, 0.0) / 2**30 for k in COLLECTIVES[:4]]
        lines.append(f"| {r['arch']} | {r['shape']} | "
                     + " | ".join(f"{x:.3f}" for x in gib) + f" | {r['exec_flops']:.4g} | "
                     + " | ".join(f"{x:.3f}" for x in coll)
                     + f" | {r.get('accum_scaled', 1)} | {r['trace_s']} |")
    return "\n".join(lines) + f"\n\n{json.dumps(counts, sort_keys=True)}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default=None, help="the mesh's device: the card unless 'cpu'")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--summary", action="store_true",
                    help="print a table of the records already in --out")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    tag = "mp" if args.multi_pod else "sp"
    if args.summary:
        print(summary(args.out, tag))
        return
    if args.all:
        failures, counts = 0, {}
        t_all = time.time()
        for arch in ARCHS:
            for shape in SHAPES:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape, "--out", args.out]
                if args.multi_pod:
                    cmd.append("--multi-pod")
                if args.device:
                    cmd += ["--device", args.device]
                t0 = time.time()
                r = subprocess.run(cmd)
                path = os.path.join(args.out, f"dryrun_{tag}_{arch}_{shape}.json")
                status = "failed"
                if r.returncode == 0 and os.path.exists(path):
                    with open(path) as f:
                        status = json.load(f)["status"]
                counts[status] = counts.get(status, 0) + 1
                failures += status == "failed"
                print(f"[{tag}] {arch} × {shape}: {status} in {time.time() - t0:.1f} s",
                      flush=True)
        print(f"dry-run sweep done in {time.time() - t_all:.1f} s: "
              f"{json.dumps(counts, sort_keys=True)}; {failures} failures")
        sys.exit(1 if failures else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    rec = trace_cell(args.arch, args.shape, args.multi_pod, args.device)
    path = os.path.join(args.out, f"dryrun_{tag}_{args.arch}_{args.shape}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[{rec['mesh']}] {args.arch} × {args.shape}: {_summary(rec)}", flush=True)


if __name__ == "__main__":
    main()
