"""Columnar table with validity mask, and the host→device upload.

Filters never compact (mask-only, branch-free — the vectorized-engine idiom);
compaction happens only at host boundaries or final output.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# the reference package uploads with jnp.asarray under JAX's default 32-bit
# mode, which demotes 64-bit columns; the port demotes the same way so both
# compute on the same dtypes (and the kernels' int32/f32 contracts hold)
_DEMOTE = {
    np.dtype(np.float64): np.float32,
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
}
_DEMOTE_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32}


def to_device(col, device) -> torch.Tensor:
    """One column onto ``device``, 64-bit types demoted to 32-bit."""
    if isinstance(col, torch.Tensor):
        return col.to(device=device, dtype=_DEMOTE_TORCH.get(col.dtype, col.dtype))
    arr = np.asarray(col)
    arr = arr.astype(_DEMOTE.get(arr.dtype, arr.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


@dataclass
class Table:
    columns: dict[str, torch.Tensor]
    valid: torch.Tensor  # bool (n,)

    @property
    def n_rows(self) -> int:
        return int(self.valid.shape[0])

    def to_numpy(self, compact: bool = True) -> dict[str, np.ndarray]:
        mask = self.valid.cpu().numpy()
        out = {}
        for k, v in self.columns.items():
            a = v.cpu().numpy()
            out[k] = a[mask] if compact else a
        return out
