"""Input/activation sharding assignment for the dry run and launchers.

Batch dims shard over the (pod×)data axes; KV/attention head dims and
expert/state dims shard over ``model``, guarded by divisibility (dims smaller
than the axis stay replicated rather than degenerately padded — e.g. the
B=1 long_500k cells). The reference's rules, as :class:`Sharding` objects
(``PartitionSpec`` entries on a ``DeviceMesh``, and so DTensor placements).
"""
from __future__ import annotations

from repro_torch.models.base import Sharding, _axis_size, fsdp_axes


def _maybe(mesh, ax, dim: int):
    """Use axis only if the dim divides evenly (else replicate)."""
    n = max(_axis_size(mesh, ax), 1)
    return ax if dim % n == 0 and dim >= n else None


def input_spec_for(name: str, shape: tuple, mesh) -> tuple:
    ax = fsdp_axes(mesh)
    d, m = ax.data, ax.model
    nd = len(shape)
    if name in ("tokens", "labels", "lengths"):
        return (_maybe(mesh, d, shape[0]), *([None] * (nd - 1)))
    if name in ("frames", "patches"):
        return (_maybe(mesh, d, shape[0]), None, None)
    if name in ("k_cache", "v_cache", "xk_cache", "xv_cache"):
        # (L, B, S, KH, hd): prefer head sharding; fall back to sequence
        # sharding over `model` when KH doesn't divide (ring-style)
        kh_ax = _maybe(mesh, m, shape[3])
        s_ax = _maybe(mesh, m, shape[2]) if kh_ax is None else None
        return (None, _maybe(mesh, d, shape[1]), s_ax, kh_ax, None)
    if name == "ssm_h":  # (L, B, H, N, P)
        return (None, _maybe(mesh, d, shape[1]), _maybe(mesh, m, shape[2]), None, None)
    if name == "conv_buf":  # (L, B, K-1, Ck)
        return (None, _maybe(mesh, d, shape[1]), None, _maybe(mesh, m, shape[3]))
    if name in ("mh", "mn"):  # (nm, B*H, 1, P, ...)
        return (None, _maybe(mesh, d, shape[1]), None, _maybe(mesh, m, shape[3]), None)
    if name in ("sc", "sn", "sm"):  # (ns, B, D)
        return (None, _maybe(mesh, d, shape[1]), _maybe(mesh, m, shape[2]))
    if name == "sy":  # (ns, B, H, P)
        return (None, _maybe(mesh, d, shape[1]), None, _maybe(mesh, m, shape[3]))
    return (None,) * nd


def batch_shardings(specs: dict, mesh) -> dict:
    return {k: Sharding(mesh, input_spec_for(k, v.shape, mesh)) for k, v in specs.items()}
