"""Mesh axes by name and the collectives on them.

A mesh (:mod:`repro_torch.launch.mesh`) is a ``DeviceMesh`` whose axes carry
the reference's names; each axis is the process group of this rank's line
along it, where the reference has a ``shard_map`` axis name. The helpers
here read an axis (``axis_size`` is ``jax.lax.psum(1, axis)``,
``axis_index`` is ``jax.lax.axis_index``) and gather along axes; the
models, the engine and the train step take them from here.

``hierarchical_psum`` is the two-level gradient reduction: reduce-scatter
and all-gather *inside* a pod (``intra_axis``), with the hop between pods
(``inter_axis``) carrying only each rank's 1/N_intra shard, the standard
bandwidth-optimal hierarchy. The reference lowers it from ``shard_map`` axis
names; here each step is an explicit collective on the mesh axis's process
group: reduce-scatter(data) → all-reduce(pod) → all-gather(data). Without a
mesh, or on a mesh without the intra axis, the tree comes back as it is
(the reference's path outside ``shard_map``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

DATA_AXES = ("pod", "data")  # the batch's axes, outermost first (``fsdp_axes``'s data)


def has_axis(mesh, axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh's batch axes, outermost first: ``("pod", "data")`` on a
    multi-pod mesh, ``("data",)`` otherwise, none without a mesh."""
    return tuple(a for a in DATA_AXES if has_axis(mesh, a))


def data_shards(mesh) -> tuple[int, int]:
    """(this rank's index, the count) of the batch's shards over the data
    axes, pod-major as ``PartitionSpec(("pod", "data"))`` lays them out;
    (0, 1) without a mesh."""
    index, count = 0, 1
    for a in data_axes(mesh):
        index, count = index * axis_size(mesh, a) + axis_index(mesh, a), count * axis_size(mesh, a)
    return index, count


def all_gather_rows(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """Every rank's ``x`` along ``axes`` concatenated on the first
    dimension, in the order of the ranks' indices (the first axis
    outermost). Booleans travel as uint8."""
    out = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    for a in reversed(axes):  # innermost first: each gather keeps the order
        n = axis_size(mesh, a)
        full = out.new_empty((n * out.shape[0], *out.shape[1:]))
        dist.all_gather_into_tensor(full, out, group=axis_group(mesh, a))
        out = full
    return out.to(torch.bool) if x.dtype == torch.bool else out


def hierarchical_psum(tree, mesh=None, intra_axis: str = "data", inter_axis: str = "pod"):
    """The sum of ``tree`` (nested dicts of tensors) over the ranks of
    ``intra_axis`` and ``inter_axis``, with the inter hop at 1/|intra|
    volume. Each leaf is flattened and zero-padded to a multiple of the
    intra size; every rank gets the sum in its leaf's shape and dtype."""
    if not has_axis(mesh, intra_axis):
        return tree
    intra, n = axis_group(mesh, intra_axis), axis_size(mesh, intra_axis)
    inter = axis_group(mesh, inter_axis) if has_axis(mesh, inter_axis) else None

    def one(leaf: torch.Tensor) -> torch.Tensor:
        flat = leaf.reshape(-1)
        flat = F.pad(flat, (0, (-flat.numel()) % n)).contiguous()
        # reduce-scatter inside the pod: each rank owns a 1/n shard of the sum
        shard = flat.new_empty(flat.numel() // n)
        dist.reduce_scatter_tensor(shard, flat, group=intra)
        if inter is not None:  # between pods, on the shard only
            dist.all_reduce(shard, group=inter)
        full = torch.empty_like(flat)
        dist.all_gather_into_tensor(full, shard, group=intra)
        return full[: leaf.numel()].reshape(leaf.shape)

    def walk(t):  # nested dicts, their order kept: every rank's collectives in one order
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) else one(t)

    return walk(tree)
