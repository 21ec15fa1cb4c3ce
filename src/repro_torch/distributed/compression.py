"""Gradient compression for a bandwidth-bound gradient all-reduce.

int8 error-feedback quantization: each leaf is quantized per-row (last-axis
blocks) to int8 with an f32 scale; the quantization error is carried in a
residual accumulator and added back before the next step's quantization, so
the *cumulative* transmitted gradient is unbiased (EF-SGD / 1-bit-Adam
family). int8 cuts transmitted bytes 4× vs f32 (2× vs bf16).

The reference's functions on trees of tensors (nested dicts), in its order
of operations: ``torch.round`` rounds halves to even, as ``jnp.round``
does. The train loop owns the residual state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import axis_group, axis_size
from repro_torch.train.optimizer import tree_map


class ErrorFeedbackState(NamedTuple):
    residual: Any  # tree matching grads (f32)


def ef_init(grads_or_params: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_or_params))


def _amax(g: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(g.float()), dim=-1, keepdim=True)


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, 1.0)


def _quant_leaf(g: torch.Tensor, scale: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization over the last axis."""
    gf = g.float()
    if scale is None:
        scale = _scale_of(_amax(gf))
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_int8_compress(grads: Any, state: ErrorFeedbackState, scales: Any = None
                     ) -> tuple[Any, Any, ErrorFeedbackState]:
    """Returns (q_tree, scale_tree, new_state). Residual carries the error.
    ``scales`` overrides the per-row scales."""
    corrected = tree_map(lambda g, r: g.float() + r, grads, state.residual)
    if scales is None:
        scales = tree_map(lambda c: _scale_of(_amax(c)), corrected)
    q = tree_map(lambda c, s: _quant_leaf(c, s)[0], corrected, scales)
    new_res = tree_map(lambda c, qq, ss: c - _dequant_leaf(qq, ss), corrected, q, scales)
    return q, scales, ErrorFeedbackState(residual=new_res)


def ef_int8_decompress(q: Any, scale: Any) -> Any:
    return tree_map(_dequant_leaf, q, scale)


def compressed_gradient_update(grads, state, *, axis_name: str | None = None, mesh=None):
    """Quantize → (optionally all-reduce over ``mesh``'s ``axis_name``) →
    dequantize, with error feedback. Returns (gradients, new state).

    With ``axis_name``, the ranks along it first agree on a per-row scale (a
    MAX all-reduce of each row's largest magnitude, O(rows) next to the
    payload), then the int8 payloads are summed as int32 (int8 would
    overflow past 127 participants) and each rank rebuilds the float32
    mean. Without it, one participant's quantize/dequantize round."""
    if axis_name is None:
        q, s, new_state = ef_int8_compress(grads, state)
        return ef_int8_decompress(q, s), new_state
    if mesh is None:
        raise ValueError(f"compressed_gradient_update(axis_name={axis_name!r}) needs the mesh "
                         "that names the axis")
    group, n = axis_group(mesh, axis_name), axis_size(mesh, axis_name)

    def agreed_scale(c):
        amax = _amax(c)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        return _scale_of(amax)

    def summed(qq):
        q32 = qq.to(torch.int32)
        dist.all_reduce(q32, group=group)
        return q32

    corrected = tree_map(lambda g, r: g.float() + r, grads, state.residual)
    q, s, new_state = ef_int8_compress(grads, state, tree_map(agreed_scale, corrected))
    deq = tree_map(lambda qq, ss: summed(qq).float() * ss / n, q, s)
    return deq, new_state
