"""Dispatch for the four main-path kernels.

Policy: a CUDA tensor goes to the hand-written kernel (``featurize``,
``tree_gemm``, ``relational``), a CPU tensor to the plain version in
:mod:`repro_torch.kernels.ref`. There is no fallback between the two: a
CUDA input whose kernel cannot build or launch raises, and an input on any
other device raises. Callers pass natural shapes; the one padding the port
keeps (the GEMM program's) is provably inert, see :func:`pad_gemm_program`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.kernels import ref as _ref


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _route(t: torch.Tensor, op: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel or plain version for device {t.device}")


def kernels_enabled() -> bool:
    """``RAVEN_KERNELS`` knob: ``off``/``0`` routes relational stages through
    the legacy torch composition (searchsorted / index_add_ / scatter_reduce
    inline in the stage) instead of :func:`gather_join_op` /
    :func:`segment_agg_op`. Anything else (the default) uses the ops, which
    dispatch to the CUDA kernels for CUDA tensors and the plain versions on
    the CPU."""
    return os.environ.get("RAVEN_KERNELS", "on").lower() not in ("off", "0")


def kernel_mode_token() -> str:
    """Content token for the relational-kernel codegen mode, folded into the
    fingerprints of stages (and plans) containing Join/Aggregate ops so the
    two ``RAVEN_KERNELS`` modes never alias. The ``rt1`` prefix is this
    package's own, so its tokens never equal the reference package's."""
    return "rt1-on" if kernels_enabled() else "rt1-off"


# ---------------------------------------------------------------------------
# tree_gemm
# ---------------------------------------------------------------------------


def pad_gemm_program(A, B, C, D, V, align: int = 8):
    """Pad F/I/L of a GEMM tree program up to multiples of ``align``.
    Inert padding proof:
      * extra F rows of A are zero → S unchanged (x is zero-padded to match,
        in the kernel or here);
      * extra I columns: threshold +inf ⇒ decision 1, but their C rows are
        zero ⇒ P unchanged;
      * extra L columns: Dcount = -1 can never equal a non-negative path
        count ⇒ match 0 ⇒ V never read (and V is 0 there anyway)."""
    T, F, I = A.shape
    L = C.shape[2]
    Fp, Ip, Lp = _round_up(F, align), _round_up(I, align), _round_up(L, align)
    A2 = np.zeros((T, Fp, Ip), np.float32)
    A2[:, :F, :I] = A
    B2 = np.full((T, Ip), np.float32(np.inf))
    B2[:, :I] = B
    C2 = np.zeros((T, Ip, Lp), np.float32)
    C2[:, :I, :L] = C
    D2 = np.full((T, Lp), np.float32(-1.0))
    D2[:, :L] = D
    V2 = np.zeros((T, Lp), np.float32)
    V2[:, :L] = V
    return A2, B2, C2, D2, V2


def tree_gemm_op(x, A, B, C, D, V, *, base: float) -> torch.Tensor:
    """(N,F) rows → (N,) raw scores; A's F may exceed x's (padded program)."""
    x = x.to(torch.float32)
    if _route(x, "tree_gemm"):
        from repro_torch.kernels.tree_gemm import tree_gemm

        return tree_gemm(x.contiguous(), A, B, C, D, V, base)
    Fk, F = A.shape[1], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, Fk - F)) if Fk > F else x
    return _ref.tree_gemm_ref(xp, A, B, C, D, V, base)


# ---------------------------------------------------------------------------
# featurize
# ---------------------------------------------------------------------------


def featurize_op(num, cat, offset, scale, cat_values, cat_segments, val_col=None):
    """Fused scaler + one-hot + concat → (N, Kn + Vtot) f32. ``val_col`` is
    the kernel's expansion of ``cat_segments`` (built from them when not
    given; programs pass the copy they hold on the device)."""
    if _route(num, "featurize"):
        from repro_torch.kernels.featurize import featurize, segment_columns

        if val_col is None:
            val_col = segment_columns(cat_segments, num.device)
        return featurize(
            num.to(torch.float32).contiguous(), cat.to(torch.int32).contiguous(),
            offset, scale, cat_values, val_col,
        )
    return _ref.featurize_ref(num, cat, offset, scale, cat_values, cat_segments)


# ---------------------------------------------------------------------------
# relational: gather-join and masked segmented aggregate
# ---------------------------------------------------------------------------


def gather_join_op(fk, skeys, spay):
    """Dim-table equi-join gather. fk:(N,) int32; skeys:(M,) sorted *unique*
    int32 dim keys; spay:(M,P) f32 payload aligned to skeys. Returns
    ``(out, hit)``: out:(N,P) f32 (zero on miss), hit:(N,) bool."""
    if _route(fk, "gather_join"):
        from repro_torch.kernels.relational import gather_join

        return gather_join(fk.contiguous(), skeys.contiguous(), spay.contiguous())
    return _ref.gather_join_ref(fk, skeys, spay)


def segment_agg_op(vals, w, sid, *, num_segments: int):
    """Masked segmented aggregate. vals:(N,C) f32; w:(N,) f32 validity
    weights (the fused filter mask); sid:(N,) int32 in [0, num_segments).
    Returns ``(counts, sums, mins, maxs)`` — counts:(S,), the rest (S,C);
    mins/maxs are +inf/-inf where a segment has no valid rows (callers
    replace empties via ``counts > 0``)."""
    if _route(vals, "segment_agg"):
        from repro_torch.kernels.relational import segment_agg

        return segment_agg(
            vals.contiguous(), w.contiguous(), sid.contiguous(),
            num_segments=num_segments,
        )
    return _ref.segment_agg_ref(vals, w, sid, num_segments=num_segments)
