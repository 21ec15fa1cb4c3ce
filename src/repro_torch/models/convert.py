"""Carry parameters from the reference package's layout into the port.

Both packages keep an LM's parameters as the same nested dict (stacked
per-layer leaves under ``layers``, or xlstm's ``mlayers`` and ``slayers``;
zamba2's ``shared`` block; weights as (in, out)), so a conversion is a
leaf-by-leaf copy that keeps each leaf's dtype: a bfloat16 model's float32
leaves (Mamba2's ``a_log`` and ``dt_bias``) stay float32. The input is that
tree with numpy arrays for leaves (``np.asarray`` of each reference leaf;
bfloat16 arrives as the ``ml_dtypes`` type, whose bits are taken as they
are).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_jax(tree, device=None) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's nested
    dict of tensors on ``device`` (the card unless asked otherwise)."""
    dev = resolve_device(device)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        return _tensor(t, dev)

    return rec(tree)
