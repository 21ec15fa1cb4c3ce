"""CUDA kernel wrapper: fused featurization (scaler + one-hot + concat).

Replaces the Pallas ``featurize`` kernel of the reference package; the
kernel itself is ``csrc/featurize.cu``. The relational→model data conversion
is one pass: a row's raw numeric columns and categorical codes are read once
and its full feature row (numerics scaled, categoricals one-hot,
concatenated numerics-first) is written once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def segment_columns(cat_segments, device=None) -> torch.Tensor:
    """Expand static ``(start, length)`` one-hot segments into ``val_col``:
    for each one-hot output column, the categorical input column it tests."""
    cols = [j for j, (_, length) in enumerate(cat_segments) for _ in range(length)]
    return torch.tensor(cols, dtype=torch.int32, device=device)


def featurize(num, cat, offset, scale, cat_values, val_col) -> torch.Tensor:
    """num:(N,Kn) f32; cat:(N,Kc) int32; offset/scale:(Kn,) f32;
    cat_values:(Vtot,) int32 concatenated category values; val_col:(Vtot,)
    int32 (see :func:`segment_columns`). All on one CUDA device, contiguous.
    Returns (N, Kn + Vtot) f32."""
    dev = num.device
    if dev.type != "cuda":
        raise ValueError(f"featurize kernel needs CUDA tensors, got {dev}")
    N, Kn = num.shape
    _build.require(num, "num", torch.float32, 2, dev)
    _build.require(cat, "cat", torch.int32, 2, dev)
    _build.require(offset, "offset", torch.float32, 1, dev)
    _build.require(scale, "scale", torch.float32, 1, dev)
    _build.require(cat_values, "cat_values", torch.int32, 1, dev)
    _build.require(val_col, "val_col", torch.int32, 1, dev)
    Kc, Vtot = cat.shape[1], cat_values.shape[0]
    if cat.shape[0] != N or offset.shape[0] != Kn or scale.shape[0] != Kn:
        raise ValueError("featurize: num/cat/offset/scale shapes disagree")
    if val_col.shape[0] != Vtot:
        raise ValueError("featurize: val_col must have one entry per category")
    out = torch.empty((N, Kn + Vtot), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _build.lib().raven_featurize(
            num.data_ptr(), cat.data_ptr(), offset.data_ptr(), scale.data_ptr(),
            cat_values.data_ptr(), val_col.data_ptr(), out.data_ptr(),
            N, Kn, Kc, Vtot, _build.stream_ptr(dev),
        )
    _build.check("featurize", err)
    _build.LAUNCHES["featurize"] += 1
    return out
