"""Optimizers: AdamW (configurable moment dtype) and Adafactor (factored).

The reference's updates, in its order of operations: every update computes
in float32 and casts back to each leaf's dtype; the moments keep the
config's ``optimizer_dtype`` (bf16 for the giants); ``step`` is a 0-d int32
tensor. Where the reference's jit donates the parameters and the state and
returns new arrays, these update the same tensors in place, under
``torch.no_grad()``, and return them.

Trees are nested dicts of tensors (the parameter dict's layout).
"""
from __future__ import annotations

import torch


def _moment_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the dicts' order (the reference's ``jax.tree.leaves``
    sorts the keys; sums over leaves here follow the dicts' order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _step0(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params, moment_dtype: str = "float32") -> dict:
    """Zeroed moments laid out as their parameters (a DTensor leaf's are
    DTensors of its placements)."""
    dt = _moment_dtype(moment_dtype)
    zeros = lambda p: torch.zeros_like(p, dtype=dt)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _step0(_device(params))}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (the tensor itself if plain)."""
    return t.to_local() if hasattr(t, "to_local") else t


@torch.no_grad()
def adamw_update(grads, opt_state, params, lr: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1):
    """Of DTensor leaves (gradients laid out as their parameters, moments
    made alike) each rank updates its shards: the update is elementwise, so
    a shard's is the whole's, in the plain path's arithmetic."""
    step = opt_state["step"] + 1
    t = _local(step).to(torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=t.device)  # noqa: E731
    bc1 = 1.0 - torch.pow(f32(b1), t)
    bc2 = 1.0 - torch.pow(f32(b2), t)

    def upd(g, m, v, p):
        g, m, v, p = (_local(x) for x in (g, m, v, p))
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
        return p

    tree_map(upd, grads, opt_state["m"], opt_state["v"], params)
    opt_state["step"].copy_(step)
    return params, opt_state


# ---------------------------------------------------------------------------
# Adafactor (factored second moment for matrices; memory ~ O(rows+cols))
# ---------------------------------------------------------------------------


def adafactor_init(params, moment_dtype: str = "float32") -> dict:
    dt = _moment_dtype(moment_dtype)

    def st(p):
        z = lambda shape: torch.zeros(shape, dtype=dt, device=p.device)  # noqa: E731
        if p.ndim >= 2:
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return {"f": tree_map(st, params), "step": _step0(_device(params))}


def _is_state(x) -> bool:
    return isinstance(x, dict) and ("vr" in x or "v" in x) and torch.is_tensor(
        x.get("vr", x.get("v")))


@torch.no_grad()
def adafactor_update(grads, opt_state, params, lr: float = 3e-4, eps: float = 1e-30,
                     decay: float = 0.8, clip: float = 1.0):
    step = opt_state["step"] + 1
    t = step.to(torch.float32)
    beta = 1.0 - torch.pow(t, -decay)

    def upd(st, g, p):
        gf = g.float()
        g2 = gf * gf + eps
        if p.ndim >= 2:
            vr = beta * st["vr"].float() + (1 - beta) * g2.mean(-1)
            vc = beta * st["vc"].float() + (1 - beta) * g2.mean(-2)
            denom = (vr[..., :, None] * vc[..., None, :]
                     / torch.clamp(vr.mean(-1)[..., None, None], min=eps))
            u = gf * torch.rsqrt(denom + eps)
            st["vr"].copy_(vr)
            st["vc"].copy_(vc)
        else:
            v = beta * st["v"].float() + (1 - beta) * g2
            u = gf * torch.rsqrt(v + eps)
            st["v"].copy_(v)
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / clip, min=1.0)
        p.copy_(p.float() - lr * u)

    def walk(st, g, p):
        if _is_state(st):
            upd(st, g, p)
        else:
            for k in st:
                walk(st[k], g[k], p[k])

    walk(opt_state["f"], grads, params)
    opt_state["step"].copy_(step)
    return params, opt_state
