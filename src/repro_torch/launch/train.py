"""Production-shaped training driver, on the card or (``--device cpu``) the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b --reduced \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --ckpt-every 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 8 --seq 4096 --batch 16

Wires together the fault-tolerance layers of the reference's driver:
  * deterministic sharded TokenLoader (dead-host shard reassignment),
  * StragglerMonitor (slow-step flagging, shard rebalancing),
  * CheckpointManager (async atomic saves, retention, resume),
  * preemption handling (SIGTERM → final blocking checkpoint → clean exit),
  * optional int8 error-feedback gradient compression.

One device: the data-parallel step over a mesh is ``make_train_step(model,
mesh)``; this loop under ``torch.distributed`` comes with the sharded
parameters (ROADMAP Queue 1 item 10). ``float(metrics["loss"])`` inside the
``StepTimer`` waits for the step, so a step's time is the card's.
"""
from __future__ import annotations

import argparse
import signal
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, load_checkpoint, restore_onto_device
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.data.loader import TokenLoader
from repro_torch.device import resolve_device
from repro_torch.distributed import (
    StepTimer,
    StragglerMonitor,
    compressed_gradient_update,
    ef_init,
)
from repro_torch.models import build_model
from repro_torch.models.zoo import _enc_frames, _vp
from repro_torch.train.optimizer import adafactor_update, adamw_update
from repro_torch.train.step import init_opt_state, loss_and_grads, make_train_step

MEMORY_RESERVE = 4 * 2**30  # bytes left free beside the chosen microbatch


def sequence_bytes(cfg, seq: int) -> int:
    """A rough peak of one sequence's training activations: the loss's
    float32 (512, Vp) chunk with its gradient and temporaries, a layer's
    input kept a layer (remat) or its activations (no remat), and the
    working set of the layer the backward is in (:func:`_layer_bytes`).
    The enc-dec also keeps each encoder layer's input over its
    ``frontend_tokens`` rows."""
    per_row = 2 * (1 if cfg.remat else 12)
    xent = 512 * _vp(cfg) * 18
    kept = cfg.n_layers * seq * cfg.d_model * per_row
    if cfg.family == "encdec":
        kept += cfg.encoder_layers * _enc_frames(cfg) * cfg.d_model * per_row
    return int(xent + kept + _layer_bytes(cfg, seq))


def _block_bytes(cfg, rows: int, kv_rows: int) -> int:
    """An attention and MLP layer over ``rows`` (keys over ``kv_rows``):
    the MLP's and projections' activations and a block of float32
    attention scores."""
    attn = cfg.n_heads * min(rows, 512) * min(kv_rows, 1024) * 4 * 8
    return rows * (cfg.d_ff * 16 + cfg.d_model * 24) + attn


def _layer_bytes(cfg, seq: int) -> int:
    """One layer's activations, recomputed in the backward, by family.

    Attention and MLP (the decoders, zamba2's shared block):
    :func:`_block_bytes`. The enc-dec: the larger of a decoder layer (its
    block, the cross-attention's score block over the encoder rows, and
    the cross K/V projected from them) and an encoder layer, whose score
    blocks are those of a ``frontend_tokens``-row query.
    xlstm: an mLSTM layer's projections and float32 SSD outputs, or an
    sLSTM layer's per-step checkpoints, which keep each step's carried
    float32 (c, n, m) and bf16 y_prev beside the (S, 4D) gate inputs.
    zamba2: a Mamba2 layer's projections, conv and gate activations and
    float32 SSD output, with one chunk's float32 (Q, Q, H) blocks
    recomputed; and, since its shared block runs outside any checkpoint
    (as in the reference), every application's activations kept."""
    D = cfg.d_model
    block = _block_bytes(cfg, seq, seq)
    if cfg.family == "encdec":
        F = _enc_frames(cfg)
        cross = (cfg.n_heads * min(seq, 512) * min(F, 1024) * 4 * 8
                 + F * cfg.n_kv_heads * cfg.hd * 2 * 2)
        return max(block + cross, _block_bytes(cfg, F, F))
    if cfg.family == "ssm":
        mlstm = seq * D * 40
        slstm = seq * D * (3 * 4 + 2 + 4 * 2 + 2)
        return max(mlstm, slstm)
    if cfg.family == "hybrid":
        mamba = seq * cfg.d_inner * 32 + cfg.ssm_chunk ** 2 * cfg.ssm_heads * 4 * 6
        return mamba + cfg.n_layers // cfg.attn_every * block
    return block


def choose_accum_steps(cfg, batch: int, seq: int, device: torch.device) -> int:
    """The fewest microbatches (a divisor of ``batch``) whose sequences fit
    the card's free memory after the parameters and optimizer state, by
    :func:`sequence_bytes`."""
    free = torch.cuda.mem_get_info(device)[0] - MEMORY_RESERVE
    for n in range(1, batch + 1):
        if batch % n == 0 and (batch // n) * sequence_bytes(cfg, seq) <= free:
            return n
    return batch


def train_loop(
    arch: str = "qwen2-0.5b",
    reduced: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    lr: float = 1e-3,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    resume: bool = False,
    compress: bool = False,
    kill_host: int | None = None,
    kill_at_step: int = -1,
    seed: int = 0,
    log_every: int = 10,
    print_fn=print,
    device=None,
    on_step=None,
) -> dict:
    """Train ``arch`` for ``steps`` steps (from the latest checkpoint with
    ``resume``). Beside the reference's arguments: ``device`` (the card
    unless ``"cpu"``) and ``on_step(step, params, metrics)``, called after
    each step. On the card the batch runs in the fewest microbatches the
    free memory allows (:func:`choose_accum_steps`); elsewhere in one, as
    the reference's. Returns the losses, the parameters, the last step run,
    the optimizer state, each step's seconds (``step_s``), each batch's
    loading seconds (``load_s``), the microbatch count and the checkpoint
    manager's ``last`` save."""
    dev = resolve_device(device)
    cfg = reduced_config(arch) if reduced else get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt_state = init_opt_state(model, params)
    ef_state = ef_init(params) if compress else None

    monitor = StragglerMonitor(n_hosts=4)
    loader = TokenLoader(global_batch=batch, seq_len=seq, vocab=cfg.vocab_size,
                         seed=seed, n_shards=4, monitor=monitor)
    mgr = CheckpointManager(ckpt_dir, keep=3) if ckpt_dir else None

    start_step = 0
    if resume and mgr is not None and mgr.latest_step() is not None:
        s, tree, meta = load_checkpoint(ckpt_dir)
        state = restore_onto_device(tree, dev)
        # leaf dtypes ride through restore_onto_device's bf16 re-view
        params, opt_state = state["params"], state["opt"]
        start_step = s + 1
        print_fn(f"resumed from step {s}")

    accum = choose_accum_steps(cfg, batch, seq, dev) if dev.type == "cuda" else 1
    update = adamw_update if cfg.optimizer == "adamw" else adafactor_update
    if compress:
        def step_fn(params, opt_state, batch, ef):
            # quantize/EF-roundtrip the grads the way the inter-pod hop would
            loss, grads = loss_and_grads(model.loss, params, batch)
            grads, ef = compressed_gradient_update(grads, ef)
            new_p, new_o = update(grads, opt_state, params, lr=lr)
            return new_p, new_o, {"loss": loss}, ef
    else:
        raw_step = make_train_step(model, lr=lr, accum_steps=accum)

    # preemption: SIGTERM triggers one final blocking checkpoint
    preempted = {"flag": False}

    def _on_term(sig, frame):
        preempted["flag"] = True

    old = signal.signal(signal.SIGTERM, _on_term)

    losses, step_s, load_s = [], [], []
    step = start_step - 1
    try:
        for step in range(start_step, steps):
            if kill_host is not None and step == kill_at_step:
                monitor.mark_dead(kill_host)  # simulate a host failure
                print_fn(f"host {kill_host} marked dead at step {step}; shards reassigned")
            # every host materializes its assigned shards; on this 1-host run
            # we assemble the full global batch (shard math identical)
            t0 = time.perf_counter()
            all_shards = [s for h, ss in monitor.plan_shards(loader.n_shards).items()
                          for s in ss]
            np_batch = loader.batch(step, sorted(all_shards))
            dev_batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
            load_s.append(time.perf_counter() - t0)
            with StepTimer(monitor) as t:
                if compress:
                    params, opt_state, metrics, ef_state = step_fn(
                        params, opt_state, dev_batch, ef_state)
                else:
                    params, opt_state, metrics = raw_step(params, opt_state, dev_batch)
                loss = float(metrics["loss"])
            losses.append(loss)
            step_s.append(t.last)
            if on_step is not None:
                on_step(step, params, metrics)
            if t.was_straggler:
                print_fn(f"step {step}: straggler step ({t.last:.2f}s)")
            if step % log_every == 0:
                print_fn(f"step {step}: loss={loss:.4f} ({t.last:.2f}s)")
            if mgr is not None and ckpt_every and (step + 1) % ckpt_every == 0:
                mgr.save(step, {"params": params, "opt": opt_state})
            if preempted["flag"]:
                print_fn(f"preempted at step {step}: draining checkpoint")
                if mgr is not None:
                    mgr.save(step, {"params": params, "opt": opt_state}, blocking=True)
                break
    finally:
        if mgr is not None:
            mgr.flush()
        signal.signal(signal.SIGTERM, old)

    return {"losses": losses, "params": params, "final_step": step, "opt_state": opt_state,
            "step_s": step_s, "load_s": load_s, "accum_steps": accum,
            "checkpoint": mgr.last if mgr is not None else {}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()
    out = train_loop(**{k.replace("-", "_"): v for k, v in vars(args).items()})
    first, last = out["losses"][0], out["losses"][-1]
    print(f"done: loss {first:.4f} -> {last:.4f}; {out['accum_steps']} microbatch(es) a "
          f"step; median step {np.median(out['step_s']):.3f} s, loader "
          f"{np.median(out['load_s']):.3f} s")
    sys.exit(0 if np.isfinite(last) else 1)


if __name__ == "__main__":
    main()
