"""Device meshes over the ranks of a ``torch.distributed`` process group.

The reference builds ``jax.sharding.Mesh`` objects over its devices; here a
mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` with the same
axis names over the group's ranks, one rank a device. Each axis is a
process group (the reference's ``shard_map`` axis name); the axes are read
and the collectives on them made in :mod:`repro_torch.distributed.collectives`.

The caller initializes the group (``torch.distributed.init_process_group``
with its address or store, world size and rank): nothing here reads a
cluster's environment. The backend follows from the device: NCCL on the
card, gloo on the CPU (:func:`backend_for`); a mesh refuses a group whose
backend does not serve its device rather than run on another one; the
dry run's ``"fake"`` group (:mod:`repro_torch.launch.dryrun`), whose
collectives move nothing, serves either.

Functions, not module-level constants, so importing this module touches no
process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

def backend_for(device=None) -> str:
    """The process group backend ``device`` needs: ``"nccl"`` for the card
    (the default), ``"gloo"`` for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _world(device) -> int:
    """The initialized default group's world size, once its backend is
    the one ``device`` needs."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"no process group: call torch.distributed.init_process_group("
            f"{backend_for(device)!r}, ...) with this rank and the world size first")
    backend = str(dist.get_backend())
    if backend_for(device) not in backend and backend != "fake":  # the dry run's group
        raise ValueError(f"a {resolve_device(device).type} mesh needs the "
                         f"{backend_for(device)} backend; the process group runs {backend}")
    return dist.get_world_size()


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], device=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axis_names`` over every rank of the
    initialized default group, on ``device``'s type (the card unless
    ``"cpu"``): the reference's ``jax.make_mesh``."""
    world, need = _world(device), math.prod(shape)
    if world != need:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs a world size of {need}; "
                         f"the process group has {world}")
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """The production mesh: ``(data 16, model 16)``, or ``(pod 2, data 16,
    model 16)`` with ``multi_pod``; a ``ValueError`` names the world size
    it needs when the group has another."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(model_parallel: int = 1, device=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over whatever ranks the group has (tests,
    local runs): ``(world // mp, mp)`` with ``mp`` at most the world size."""
    n = _world(device)
    mp = min(model_parallel, n)
    return make_mesh((n // mp, mp), ("data", "model"), device)
