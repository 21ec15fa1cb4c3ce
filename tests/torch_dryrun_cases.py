"""The multi-process cases of ``tests/test_torch_dryrun.py``.

Each entry point runs in processes of its own, since a default process
group must not outlive its test in a shared test worker. None imports JAX
or the reference package.

* ``python -m tests.torch_dryrun_cases placements OUT``: "fake" groups of 256
  and 512 ranks (rank 0) and the production meshes on them; the
  :class:`Sharding` of every leaf of the ten full configs' parameters and
  AdamW state, of every input of every arch × shape, the decode caches'
  order, and rank 0's local shape of each (DTensor's own arithmetic).
* ``python -m tests.torch_dryrun_cases dryrun OUT``: the dry run of the
  reduced ``dense`` and ``vlm`` configs on 256 fake ranks (``device="cpu"``),
  the unsharded steps' FLOPs counted the same way, a ``moe`` cell, and the
  collective bytes of one known redistribution.
* ``python -m tests.torch_dryrun_cases gloo RANK DIR``: one of four gloo
  ranks on the CPU (the group met through a file in ``DIR``): reduced
  qwen2-0.5b on (data 2, model 2) and (data 1, model 4), granite-3-8b and
  llava-next-34b with parameters placed by ``shardings_for`` through
  ``Model.loss``, ``prefill``, ``decode`` and ``make_train_step``, the
  attention operators' sharding rules, and ``restore_onto_mesh`` of the
  reference's checkpoint; results in ``DIR/rank_RANK.npz``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

# (name, reduced arch, mesh shape, batch, text length): the gloo cases
SERVE_CASES = (
    ("qwen_2x2", "qwen2-0.5b", (2, 2), 4, 16),
    ("qwen_1x4", "qwen2-0.5b", (1, 4), 4, 16),
    ("granite_2x2", "granite-3-8b", (2, 2), 4, 16),
    ("llava_1x4", "llava-next-34b", (1, 4), 8, 16),
)
WORLD = 4
LR = 1e-3
EXTRA = 4  # cache rows past the prompt
RESTORE_MESH = (2, 2)
# the reduced dry-run cells: arch, kind, global batch, sequence
DRY_CELLS = (
    ("qwen2-0.5b", "train", 32, 64), ("qwen2-0.5b", "prefill", 32, 64),
    ("qwen2-0.5b", "decode", 32, 64),
    ("granite-3-8b", "train", 64, 64), ("granite-3-8b", "prefill", 32, 64),
    ("granite-3-8b", "decode", 32, 64),
    ("llava-next-34b", "train", 128, 80), ("llava-next-34b", "prefill", 32, 80),
    ("llava-next-34b", "decode", 32, 80),
)


def case_config(reduced_config, arch: str):
    """The reduced config of a case, float32. llava's keeps its padding of
    the heads at a width where it pads: 6 heads over 2 KV heads padded to
    8 (``reduced_config`` leaves 4 heads under ``tp_pad_heads=64``)."""
    cfg = reduced_config(arch, dtype="float32")
    if cfg.family == "vlm":
        cfg = dataclasses.replace(cfg, d_model=96, n_heads=6, n_kv_heads=2, tp_pad_heads=8)
    return cfg


def case_batch(cfg, B: int, S: int) -> dict:
    """Tokens and labels (labels below 0 in the first half of the rows);
    patches for the vlm; the next tokens for one decode step."""
    rng = np.random.default_rng(7)
    out = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
           for k in ("tokens", "labels")}
    out["labels"][: B // 2, :5] = -1
    if cfg.frontend == "vision":
        out["patches"] = (rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)) * 0.5
                          ).astype(np.float32)
    out["next"] = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    return out


def prompt_len(cfg, S: int) -> int:
    return S + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)


def restore_tree() -> dict:
    """A tree for the restore case: float32 and bfloat16 (as its uint16
    bits) leaves whose rows and columns the (2, 2) mesh shards."""
    rng = np.random.default_rng(13)
    bf16 = (rng.normal(size=(3, 8, 12)).astype(np.float32).view(np.uint32) >> 16
            ).astype(np.uint16)
    return {"embed": rng.normal(size=(16, 6)).astype(np.float32),
            "layers": {"attn": {"wq_col": bf16, "bq_col": rng.normal(size=(3, 12)).astype(
                np.float32)}, "ln1": rng.normal(size=(3, 8)).astype(np.float32)},
            "step": np.array(7, dtype=np.int32)}


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


# ---------------------------------------------------------------------------
# placements of the full configs
# ---------------------------------------------------------------------------


def _spec(spec) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def placements(out_path: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shardings import batch_shardings
    from repro_torch.models import build_model
    from repro_torch.models.base import SHAPES, shardings_for, struct, tree_paths
    from repro_torch.models.zoo import cache_names
    from repro_torch.train.step import init_opt_state

    out: dict = {}
    for multi_pod, world in ((False, 256), (True, 512)):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        tag = "2x16x16" if multi_pod else "16x16"

        def record(tree, shardings):
            got = {}
            for path, sh in tree_paths(shardings).items():
                shape = tuple(tree_paths(tree)[path].shape)
                local = compute_local_shape_and_global_offset(shape, mesh, sh.placements)[0]
                got[path] = {"spec": _spec(sh.spec), "shard": list(sh.shard_shape(shape)),
                             "local": list(local), "placements": [repr(p) for p in sh.placements]}
            return got

        for arch in ARCHS:
            model = build_model(get_config(arch))
            params = {k: v for k, v in _structs(model.shapes, struct, torch.bfloat16).items()}
            opt = init_opt_state(model, params, materialize=False)
            out[f"{tag}/{arch}/params"] = record(params, shardings_for(params, mesh))
            out[f"{tag}/{arch}/opt"] = record(opt, shardings_for(opt, mesh))
            for name, sp in SHAPES.items():
                specs = model.input_specs(sp)
                out[f"{tag}/{arch}/inputs/{name}"] = {
                    "order": list(specs), "dtypes": {k: str(v.dtype) for k, v in specs.items()},
                    **record(specs, batch_shardings(specs, mesh))}
            out[f"{tag}/{arch}/caches"] = list(cache_names(model.cfg))
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def _structs(shapes: dict, struct, dtype) -> dict:
    return {k: _structs(v, struct, dtype) if isinstance(v, dict) else struct(v, dtype)
            for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# the dry run of the reduced configs
# ---------------------------------------------------------------------------


def dryrun(out_path: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import reduced_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.base import ShapeSpec

    torch.manual_seed(0)
    out: dict = {}
    for arch, kind, B, S in DRY_CELLS:
        cfg = case_config(reduced_config, arch)
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        sp = ShapeSpec(f"{kind}_{S}", kind, S, B)
        rec = D.trace_cell(arch, sp.name, device="cpu", cfg=cfg, sp=sp)
        rec["unsharded_flops"], rec["attention_flops"] = _unsharded(cfg, sp)
        out[f"{arch}/{kind}"] = rec
    out["moe"] = D.trace_cell("qwen2-moe-a2.7b", "train_4k", device="cpu")
    out["skipped"] = D.trace_cell("qwen2-0.5b", "long_500k", device="cpu")

    # one known redistribution: (16, 8) float32 rows over 4 ranks, gathered
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = make_mesh((4,), ("model",), "cpu")
    x = distribute_tensor(torch.zeros(16, 8), mesh, [Shard(0)], src_data_rank=None)
    _, cost = analyze(lambda: x.redistribute(mesh, [Replicate()]).to_local())
    _, cost2 = analyze(lambda: (x.sum() * 1.0).full_tensor())
    out["redistribute"] = {"gather": cost.collective_bytes, "sum": cost2.collective_bytes}
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def _unsharded(cfg, sp) -> tuple[float, float]:
    """The FLOPs of the cell's step on one rank without a mesh, counted as
    the dry run counts them (fake tensors, the kernels' formulas), and the
    part of them its attention takes, a train step's backward included
    (the FLOPs less those of the same step with every attention a copy of
    its query): (all, attention)."""
    from repro_torch.models import layers as L

    names = ("attention_train", "flash_attention_op", "decode_attention_op")
    real = {n: getattr(L, n) for n in names}
    whole = _step_flops(cfg, sp)
    try:
        for n in names:
            setattr(L, n, lambda q, *a, **k: q * 1)
        rest = _step_flops(cfg, sp)
    finally:
        for n, fn in real.items():
            setattr(L, n, fn)
    return whole, whole - rest


def _step_flops(cfg, sp) -> float:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.models import build_model
    from repro_torch.train.step import loss_and_grads

    model = build_model(cfg)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    with FakeTensorMode():
        params = _structs(model.shapes, lambda s, d: torch.empty(s, dtype=d), dt)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in model.input_specs(sp).items()}
        if sp.kind == "train":
            mb = {k: v[:sp.global_batch // cfg.accum_steps] for k, v in batch.items()}
            return float(cfg.accum_steps * analyze(loss_and_grads, model.loss, params, mb)[1].flops)
        with torch.no_grad():
            if sp.kind == "prefill":
                return float(analyze(model.prefill, params, batch)[1].flops)
            small = {k: batch[k] for k in ("tokens", "lengths")}
            caches = (batch["k_cache"], batch["v_cache"])
            return float(analyze(model.decode, params, small, caches)[1].flops)

# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------


def gloo(rank: int, d: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'rdv')}",
                            rank=rank, world_size=WORLD)
    try:
        out = _gloo_cases(d)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(d, f"rank_{rank}.npz"), **out)


def _full(t):
    from torch.distributed.tensor import DTensor

    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()


def _gloo_cases(d: str) -> dict:
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.checkpoint import load_checkpoint, restore_onto_mesh
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import batch_shardings
    from repro_torch.models import build_model
    from repro_torch.models.base import shardings_for
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train.step import init_opt_state, make_train_step

    inp = np.load(os.path.join(d, "inputs.npz"))
    out: dict[str, np.ndarray] = {}

    def place(tree, shardings):
        if isinstance(tree, dict):
            return {k: place(tree[k], shardings[k]) for k in tree}
        return distribute_tensor(tree, shardings.mesh, shardings.placements, src_data_rank=None)

    for name, arch, shape, B, S in SERVE_CASES:
        cfg = case_config(reduced_config, arch)
        model = build_model(cfg)
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        host = nest({k[len(arch) + 1:]: inp[k] for k in inp.files if k.startswith(arch + "/")})
        params = params_from_jax(host, device="cpu")
        params = place(params, shardings_for(params, mesh))
        nb = case_batch(cfg, B, S)
        batch = {k: torch.from_numpy(v) for k, v in nb.items() if k != "next"}
        batch = place(batch, batch_shardings(batch, mesh))
        with torch.no_grad():
            out[f"{name}/loss"] = _full(model.loss(params, batch))
            logits, caches = model.prefill(params, batch, cache_len=prompt_len(cfg, S) + EXTRA)
        out[f"{name}/prefill/logits"] = _full(logits)
        for i, c in enumerate(caches):
            out[f"{name}/prefill/cache{i}"] = _full(c)
            out[f"{name}/prefill/placements{i}"] = np.array(str(tuple(c.placements)))
        step = {"tokens": torch.from_numpy(nb["next"]),
                "lengths": torch.full((B,), prompt_len(cfg, S), dtype=torch.int32)}
        step = place(step, batch_shardings(step, mesh))
        with torch.no_grad():
            logits, caches = model.decode(params, step, caches)
        out[f"{name}/decode/logits"] = _full(logits)
        for i, c in enumerate(caches):
            out[f"{name}/decode/cache{i}"] = _full(c)
        train = {k: v for k, v in batch.items()}
        opt = init_opt_state(model, params)
        p2, opt, metrics = make_train_step(model, mesh, lr=LR, accum_steps=cfg.accum_steps)(
            params, opt, train)
        out[f"{name}/train/loss"] = metrics["loss"].numpy()
        out[f"{name}/train/grad_norm"] = metrics["grad_norm"].numpy()
        for part, tree in (("params", p2), ("m", opt["m"])):
            for k, v in flat(tree).items():
                out[f"{name}/train/{part}/{k}"] = _full(v)

    # the attention operators' sharding rules, on DTensors directly
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    g = torch.Generator().manual_seed(3)
    q, k = torch.randn(4, 6, 8, 16, generator=g), torch.randn(4, 6, 4, 16, generator=g)
    v = torch.randn(4, 6, 4, 16, generator=g)
    out["ops/flash/plain"] = ops.flash_attention_op(q, k, v).numpy()
    for tag, pl in (("batch", [Shard(0), Replicate()]), ("heads", [Replicate(), Shard(2)]),
                    ("both", [Shard(0), Shard(2)])):
        dq, dk, dv = (distribute_tensor(t, mesh, pl, src_data_rank=None) for t in (q, k, v))
        got = ops.flash_attention_op(dq, dk, dv)
        out[f"ops/flash/{tag}"] = _full(got)
        out[f"ops/flash/{tag}/placements"] = np.array(str(tuple(got.placements)))
    qd, lengths = q[:, 0], torch.tensor([6, 1, 3, 5], dtype=torch.int32)
    out["ops/decode/plain"] = ops.decode_attention_op(qd, k, v, lengths).numpy()
    for tag, (pq, pk) in (("batch", ([Shard(0)] * 2, [Shard(0)] * 2)),
                          ("heads", ([Replicate(), Shard(1)], [Replicate(), Shard(2)]))):
        dq = distribute_tensor(qd, mesh, pq, src_data_rank=None)
        dk, dv = (distribute_tensor(t, mesh, pk, src_data_rank=None) for t in (k, v))
        dl = distribute_tensor(lengths, mesh, [pq[0], Replicate()], src_data_rank=None)
        got = ops.decode_attention_op(dq, dk, dv, dl)
        out[f"ops/decode/{tag}"] = _full(got)
        out[f"ops/decode/{tag}/placements"] = np.array(str(tuple(got.placements)))

    # restore_onto_mesh of the reference's checkpoint
    mesh = make_mesh(RESTORE_MESH, ("data", "model"), "cpu")
    step, tree, _ = load_checkpoint(os.path.join(d, "ckpt"))
    placed = restore_onto_mesh(tree, shardings_for(tree, mesh))
    for k, t in flat(placed).items():
        local = t.to_local()
        out[f"restore/{k}/local"] = _bits(local)
        out[f"restore/{k}/full"] = _bits(t.full_tensor())
        out[f"restore/{k}/dtype"] = np.array(str(t.dtype))
        out[f"restore/{k}/coordinate"] = np.array(mesh.get_coordinate())
        out[f"restore/{k}/placements"] = np.array(str(tuple(t.placements)))
    out["restore/step"] = np.array(step)
    return out


def _bits(t) -> np.ndarray:
    import torch

    t = t.detach().contiguous()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


if __name__ == "__main__":
    if sys.argv[1] == "placements":
        placements(sys.argv[2])
    elif sys.argv[1] == "dryrun":
        dryrun(sys.argv[2])
    else:
        gloo(int(sys.argv[2]), sys.argv[3])
