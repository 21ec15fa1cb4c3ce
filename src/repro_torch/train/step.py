"""Step builders: train_step / prefill_step / serve_step.

The reference jits these; here they are plain functions over the parameter
dict. The train step turns on ``requires_grad`` on the leaves it trains
(every leaf of the dict, as the reference differentiates the whole tree),
takes the gradients with autograd, turns it off again and updates the
leaves in place: the ``Model``'s frozen parameters share their storage and
see the update. Gradient accumulation splits the batch along its leading
dimension into ``accum_steps`` microbatches, scales each microbatch's loss
by ``1/accum_steps`` inside the differentiated function, and sums the
gradients into accumulators of the optimizer's dtype, as the reference's
``lax.scan`` does. Over a mesh the step is data-parallel, its collectives
explicit (:func:`make_train_step`), or, on parameters placed by
``shardings_for`` (DTensors), the reference's jitted step on sharded
arrays.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import (
    axis_group,
    axis_size,
    data_axes,
    data_shards,
    has_axis,
    hierarchical_psum,
)
from repro_torch.models import layers as L
from repro_torch.models.moe import sharded_batch
from repro_torch.models.zoo import params_sharded
from repro_torch.train.optimizer import (
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    tree_leaves,
    tree_map,
)


def init_opt_state(model, params, materialize: bool = True) -> dict:
    """The optimizer state of ``model``'s config for ``params``; with
    ``materialize=False`` the same tree on the ``meta`` device (shapes and
    dtypes, no memory: the reference's ``jax.eval_shape``)."""
    cfg = model.cfg
    init = adamw_init if cfg.optimizer == "adamw" else adafactor_init
    if materialize:
        return init(params, cfg.optimizer_dtype)
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
    return init(meta, cfg.optimizer_dtype)


def _flat(tree, prefix: str = "") -> dict:
    """Leaves by path, keys sorted at every level (``jax.tree.leaves``'s
    order, which the reference's ``grad_norm`` sums in)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def loss_and_grads(loss_fn, params, batch, scale: float = 1.0):
    """``loss_fn(params, batch) * scale`` and its gradient in every leaf of
    ``params`` (a tree of the same layout, each in its leaf's dtype). On
    DTensor leaves the loss comes back a plain scalar, every rank's alike,
    and each gradient laid out as its leaf: the partial sums DTensor's
    backward leaves are reduced (over the data axes a reduce-scatter where
    the leaf is sharded there, an all-reduce where it is replicated)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, batch)
            if L.sharded(loss):
                loss = loss.full_tensor()
            if scale != 1.0:
                loss = loss * scale
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    # a leaf the loss does not reach gets zeros, as under jax.grad
    it = (torch.zeros_like(p) if g is None
          else g.redistribute(p.device_mesh, p.placements) if L.sharded(g) else g
          for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def microbatch(batch: dict, lo: int, n: int) -> dict:
    """Rows [lo, lo + n) of every leaf; a DTensor's (sharded over the data
    axes, so gathered to slice) laid out again over them."""
    out = {}
    for k, v in batch.items():
        v = v[lo:lo + n]
        out[k] = L.with_placements(v, data=L.batch_placement(v)) if L.sharded(v) else v
    return out


def make_train_step(model, mesh=None, lr: float = 3e-4, accum_steps: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``metrics`` holds the loss (a float32 tensor on the
    device), ``grad_norm`` over the float32 gradients and ``grad_norms``,
    each leaf's by its path (``layers/attn/wq_col``).

    With a ``mesh``, data parallelism over its ``data`` (and ``pod``)
    axes, the reference's step jitted with the batch sharded over them made
    explicit: the parameters and optimizer state are replicated, each rank
    takes its contiguous slice of every microbatch (pod-major), and the
    gradient is summed with :func:`hierarchical_psum` before the update,
    which every rank then makes alike. The loss is a mean over the labels
    >= 0, and ranks may hold different counts of them, so each rank's loss
    (and so its gradient) is weighted by its count over the all-reduced
    total before the sum: the sum is then the whole batch's mean and its
    gradient. ``grad_norm`` and ``grad_norms`` are the summed gradient's.
    A moe layer's blocks, capacity and positions are the whole
    microbatch's (:func:`~repro_torch.models.moe.sharded_batch`), so the
    ranks drop the assignments the reference drops.

    Parameters placed by ``shardings_for`` on ``mesh`` (DTensors; the
    dense and vlm families) take the reference's step on sharded arrays
    instead, on any mesh, a ``model`` axis of more than one rank included:
    microbatch i is rows [i·n, (i + 1)·n) of the whole batch (a DTensor
    batch laid out again over the data axes), its loss and gradients
    DTensor's (:func:`loss_and_grads`), the update on every rank's shards,
    the metrics plain. The call chooses by its parameters; plain
    parameters on a ``model`` axis of more than one rank are refused.
    ``opt_state`` is ``init_opt_state`` of the parameters (moments laid out
    alike)."""
    cfg = model.cfg
    update = adamw_update if cfg.optimizer == "adamw" else adafactor_update
    acc_dtype = torch.bfloat16 if cfg.optimizer_dtype == "bfloat16" else torch.float32
    tp = has_axis(mesh, "model") and axis_size(mesh, "model") > 1
    if mesh is not None and not has_axis(mesh, "data"):
        raise ValueError(f"a data-parallel step needs a 'data' axis; the mesh has "
                         f"{mesh.mesh_dim_names}")

    def weights(mbs: list[dict], dp) -> list[float]:
        """Each microbatch's loss weight on this rank: its count of labels
        >= 0 over the count across the data axes (1.0 without ``dp``)."""
        if dp is None:
            return [1.0] * len(mbs)
        mine = torch.stack([(mb["labels"] >= 0).sum() for mb in mbs]).to(torch.float32)
        total = mine.clone()
        for a in data_axes(dp):
            dist.all_reduce(total, group=axis_group(dp, a))
        return [max(m, 1.0) / max(t, 1.0) for m, t in zip(mine.tolist(), total.tolist())]

    def train_step(params, opt_state, batch):
        B = next(iter(batch.values())).shape[0]
        if B % accum_steps:
            # the reference's reshape into microbatches refuses it too
            raise ValueError(f"a batch of {B} does not split into {accum_steps} microbatches")
        sharded = params_sharded(params)
        if sharded and mesh is not None and tree_leaves(params)[0].device_mesh != mesh:
            raise ValueError("the parameters are placed on another mesh than the step's")
        if tp and not sharded:
            raise ValueError("a 'model' axis of more than one rank shards the parameters: "
                             "place them with shardings_for (DTensors), or replicate them "
                             "over a (data, model=1) mesh")
        dp = None if sharded else mesh  # the explicit data-parallel path's mesh
        shard, n_shards = data_shards(dp)
        n = B // accum_steps
        if n % n_shards:
            raise ValueError(f"a microbatch of {n} does not split over {n_shards} data ranks")
        m = n // n_shards
        mbs = [microbatch(batch, i * n + shard * m, m) for i in range(accum_steps)]
        ws = weights(mbs, dp)
        # a moe layer routes each microbatch as a whole (moe.sharded_batch)
        with contextlib.ExitStack() as ctx:
            if dp is not None:
                ctx.enter_context(sharded_batch(dp, n))
            if sharded:
                ctx.enter_context(L.replicate_plain())
            if accum_steps == 1:
                loss, grads = loss_and_grads(model.loss, params, mbs[0], scale=ws[0])
            else:
                inv = 1.0 / accum_steps
                grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype), params)
                loss = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(params)[0].device)
                for mb, w in zip(mbs, ws):
                    l, g = loss_and_grads(model.loss, params, mb, scale=inv * w)
                    tree_map(lambda a, gg: a.add_(gg.to(acc_dtype)), grads, g)
                    loss = loss + l
                    del g
            if dp is not None:
                grads = hierarchical_psum(grads, dp, "data", "pod")
                for a in data_axes(dp):
                    dist.all_reduce(loss, group=axis_group(dp, a))
            params, opt_state = update(grads, opt_state, params, lr=lr)
            sq = {path: torch.sum(torch.square(g.float())) for path, g in _flat(grads).items()}
            sq = {k: v.full_tensor() if L.sharded(v) else v for k, v in sq.items()}
        gnorm = torch.sqrt(sum(sq.values()))
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "grad_norms": {k: torch.sqrt(v) for k, v in sq.items()}}

    return train_step


def make_prefill_step(model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model):
    """One decode step: greedy next token + updated caches."""

    def serve_step(params, batch, caches):
        logits, caches = model.decode(params, batch, caches)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, caches

    return serve_step
