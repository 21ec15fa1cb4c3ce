"""Whether ``torch.utils.flop_counter.FlopCounterMode`` changes a training
step's bits, on one NVIDIA card, with ``chip_smoke.py``'s qwen2-0.5b step:

    python3 tools/flop_counter_bits.py

One step of TRAIN_BATCH x TRAIN_SEQ loader tokens through
``make_train_step`` from the same seeded parameters, four ways: plain,
plain under the mode, on DTensor parameters placed by ``shardings_for``
over a one-rank NCCL mesh, and that under the mode. Each is held against
the plain step: the loss, every parameter and AdamW first moment bit for
bit (the leaves that differ, the moments' largest difference) and the
gradient norms by leaf. Prints the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.data.loader import TokenLoader
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import choose_accum_steps
    from repro_torch.models import build_model, zoo
    from repro_torch.models.base import shardings_for
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.step import init_opt_state, make_train_step

    if not torch.cuda.is_available():
        print("flop_counter_bits: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # a store in this process: no port, so two checkouts on one machine
    # cannot collide
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        cfg = get_config(CS.TRAIN_ARCH)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(CS.TRAIN_SEED),
                            device=dev)
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        accum = choose_accum_steps(cfg, CS.TRAIN_BATCH, CS.TRAIN_SEQ, dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenLoader(
            global_batch=CS.TRAIN_BATCH, seq_len=CS.TRAIN_SEQ, vocab=cfg.vocab_size,
            seed=CS.TRAIN_SEED).batch(0).items()}

        def full(tree) -> dict:
            return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                    for k, v in zoo._leaves(tree)}

        def run(placed: bool, counted: bool):
            p = tree_map(torch.clone, params)
            if placed:
                p = tree_map(lambda a, sh: distribute_tensor(a, mesh, sh.placements,
                                                             src_data_rank=None),
                             p, shardings_for(p, mesh))
            o = init_opt_state(model, p)
            step = make_train_step(model, mesh if placed else None, lr=CS.TRAIN_LR,
                                   accum_steps=accum)
            t0 = time.perf_counter()
            if counted:
                with FlopCounterMode(display=False):
                    p, o, m = step(p, o, batch)
            else:
                p, o, m = step(p, o, batch)
            print(f"{'DTensor' if placed else 'plain'}{' under the mode' if counted else ''}: "
                  f"loss {float(m['loss'])!r} in {time.perf_counter() - t0:.2f} s", flush=True)
            return (float(m["loss"]), full(p), full(o["m"]),
                    {k: float(v) for k, v in m["grad_norms"].items()})

        base = run(False, False)
        print(f"{CS.TRAIN_ARCH} {CS.TRAIN_BATCH} x {CS.TRAIN_SEQ}, {accum} microbatch(es)",
              flush=True)
        for placed, counted in ((False, True), (True, False), (True, True)):
            loss, p, m, gn = run(placed, counted)
            moved = [k for k in p if not torch.equal(p[k], base[1][k])]
            moments = {k: float((m[k] - base[2][k]).abs().max()) for k in m
                       if not torch.equal(m[k], base[2][k])}
            norms = [k for k in gn if gn[k] != base[3][k]]
            print(f"  against the plain step: loss equal {loss == base[0]}; parameters "
                  f"differing {moved}; first moments differing (largest difference) "
                  f"{moments}; gradient norms differing {norms}", flush=True)
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
