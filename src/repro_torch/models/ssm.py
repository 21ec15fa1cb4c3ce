"""SSM blocks: Mamba2 (chunked SSD) and xLSTM (mLSTM matrix memory, sLSTM).

The reference package's ``models/ssm.py`` on PyTorch, on the same layouts
and with every cast where the reference has it. The chunked SSD is shared:
within a chunk of length Q the recurrence is materialised as a (Q, Q)
decay-masked contraction (Mamba2's "quadratic mode"); across chunks the
reference's ``lax.scan`` becomes a Python loop carrying the (B, H, N, P)
float32 state. The log decays' cumulative sum, the ``clip(-60, 0)`` and the
``exp`` run in float32 in the reference's order, and y is cast back to x's
type at the end.

mLSTM is the same machinery with B←k, C←q, the exponential input gate as dt
and the forget gate as the decay, heads folded into the batch; its
normaliser is the same SSD with x ≡ 1. sLSTM is a true sequential loop over
time (scalar memory with per-head recurrent mixing), as in the reference.
Where autograd records (training), each chunk step and each sLSTM step
runs under a checkpoint, as the reference's scan bodies run under
``jax.checkpoint``: the backward recomputes a chunk's decay blocks and a
step's gates instead of keeping them, and the forward's bits are the same.

Decode steps are one-token recurrent updates against the carried state (and
Mamba2's conv buffer of K − 1 rows): O(1) in the sequence length. They
return new state tensors; the model's decode writes them into its caches.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def cc_f(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _decay(t: torch.Tensor) -> torch.Tensor:
    """exp(clip(t, -60, 0)) of float32 log decays."""
    return torch.exp(torch.clamp(t, -60.0, 0.0))


def _recording(*ts) -> bool:
    """Whether autograd records an op on any of ``ts`` (None skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _recorded(fn):
    """``fn`` under ``torch.utils.checkpoint``: the reference's
    ``jax.checkpoint`` on a scan body. The backward recomputes what ``fn``
    would keep (an SSD chunk's (B, Q, Q, H) decay blocks, an sLSTM step's
    gates) from its inputs; the forward's values are ``fn``'s bit for bit.
    No random op runs inside, so no RNG state is kept."""
    return partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False)


# ---------------------------------------------------------------------------
# Generic chunked SSD:  h_t = a_t · h_{t-1} + dt_t · (b_t ⊗ x_t),
#                       y_t = c_t · h_t
# ---------------------------------------------------------------------------


def _ssd_chunk(h, xb, ab, bb, cb, db, mask):
    """One chunk of the SSD from the carried state h (B,H,N,P) f32: returns
    (the state after the chunk, the chunk's y (B,Q,H,P) f32)."""
    L = torch.cumsum(ab, dim=1)  # (B,Q,H)
    # intra-chunk: W[t,i,h] = exp(L_t - L_i) · (c_t·b_i), i<=t
    cbm = torch.einsum("bqn,bin->bqi", cb.to(torch.float32), bb.to(torch.float32))
    decay = _decay(L[:, :, None, :] - L[:, None, :, :])  # (B,Q,Q,H)
    W = cbm[..., None] * decay * mask[None, :, :, None]
    xt = xb.to(torch.float32) * db[..., None]  # (B,Q,H,P)
    y_intra = torch.einsum("bqih,bihp->bqhp", W, xt)
    # inter-chunk: y += c_t · h · exp(L_t)
    y_inter = torch.einsum("bqn,bhnp,bqh->bqhp", cc_f(cb), h, _decay(L))
    # state update: h' = h·exp(L_last) + Σ_i b_i ⊗ x̃_i · exp(L_last - L_i)
    last = L[:, -1:, :]  # (B,1,H)
    w_state = _decay(last - L)  # (B,Q,H)
    h = h * _decay(last[:, 0][:, :, None, None]) + torch.einsum(
        "bin,bih,bihp->bhnp", cc_f(bb), w_state, xt
    )
    return h, y_intra + y_inter


def ssd_chunked(
    x: torch.Tensor,      # (B,S,H,P)
    a_log: torch.Tensor,  # (B,S,H)  log decay per step (<= 0)
    b: torch.Tensor,      # (B,S,N)
    c: torch.Tensor,      # (B,S,N)
    dt: torch.Tensor,     # (B,S,H)  input scale
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) in x's dtype, the final state (B,H,N,P) f32).
    A ragged last chunk is zero-padded (a zero log decay and a zero input
    leave the state as it is)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nb = x.shape[1] // Q

    xc = x.reshape(B, nb, Q, H, P)
    ac = a_log.reshape(B, nb, Q, H).to(torch.float32)
    bc = b.reshape(B, nb, Q, N)
    cc = c.reshape(B, nb, Q, N)
    dc = dt.reshape(B, nb, Q, H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))

    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device) if h0 is None else h0
    step = _recorded(_ssd_chunk) if _recording(x, a_log, b, c, dt, h0) else _ssd_chunk
    ys = []
    for j in range(nb):
        h, y = step(h, xc[:, j], ac[:, j], bc[:, j], cc[:, j], dc[:, j], mask)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, nb * Q, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_decode_step(
    h: torch.Tensor,      # (B,H,N,P) f32
    x: torch.Tensor,      # (B,H,P)
    a_log: torch.Tensor,  # (B,H)
    b: torch.Tensor,      # (B,N)
    c: torch.Tensor,      # (B,N)
    dt: torch.Tensor,     # (B,H)
) -> tuple[torch.Tensor, torch.Tensor]:
    a = _decay(a_log.to(torch.float32))
    xt = x.to(torch.float32) * dt[..., None]
    h_new = h * a[..., None, None] + torch.einsum("bn,bhp->bhnp", cc_f(b), xt)
    y = torch.einsum("bn,bhnp->bhp", cc_f(c), h_new)
    return h_new, y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 layer
# ---------------------------------------------------------------------------


def _silu_in_f32(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(t.to(torch.float32)).to(dtype)


def mamba2_proj(p: dict, x: torch.Tensor, cfg):
    """Input projections (separate matrices, as the reference keeps them
    for its tensor-parallel shard boundaries): z, x, B, C, dt."""
    return x @ p["wz_col"], x @ p["wx_col"], x @ p["wb"], x @ p["wc"], x @ p["wdt"]


def _causal_conv(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. xs: (B,S,Ck); w: (K,Ck)."""
    K = w.shape[0]
    pad = F.pad(xs, (0, 0, K - 1, 0))
    return sum(pad[:, i : i + xs.shape[1], :] * w[i][None, None, :] for i in range(K))


def _gates(dt: torch.Tensor, p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(dt, log decay) in float32: softplus(dt + dt_bias), -exp(a_log)·dt."""
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    return dt, -torch.exp(p["a_log"]) * dt


def mamba2_layer(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    B, S, D = x.shape
    din, H = cfg.d_inner, cfg.ssm_heads
    P = din // H
    z, xs, bmat, cmat, dt = mamba2_proj(p, x, cfg)
    xs = _silu_in_f32(_causal_conv(xs, p["conv_x"]), x.dtype)
    bmat = _silu_in_f32(_causal_conv(bmat, p["conv_b"]), x.dtype)
    cmat = _silu_in_f32(_causal_conv(cmat, p["conv_c"]), x.dtype)
    dt, a_log = _gates(dt, p)  # (B,S,H)
    xh = xs.reshape(B, S, H, P)
    y, _ = ssd_chunked(xh, a_log, bmat, cmat, dt, chunk=cfg.ssm_chunk)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, din) * _silu_in_f32(z, x.dtype)
    return y @ p["wout_row"]


def mamba2_decode(p: dict, x: torch.Tensor, state, cfg):
    """x: (B,D) one token; state: (h (B,H,N,P) f32, conv_buf (B,K-1,Ck)).
    Returns (out (B,D), (h', conv_buf'))."""
    B, D = x.shape
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = din // H
    h, conv_buf = state  # conv_buf: (B, K-1, din + 2N)
    z, xs, bmat, cmat, dt = mamba2_proj(p, x, cfg)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)  # (B, din+2N)
    window = torch.cat([conv_buf, conv_in[:, None, :]], dim=1)
    wfull = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], dim=-1)
    conv_out = _silu_in_f32(torch.einsum("bkc,kc->bc", window, wfull), x.dtype)
    xs, bmat, cmat = torch.split(conv_out, [din, N, N], dim=-1)
    dt, a_log = _gates(dt, p)  # (B,H)
    h_new, y = ssd_decode_step(h, xs.reshape(B, H, P), a_log, bmat, cmat, dt)
    y = y + xs.reshape(B, H, P) * p["d_skip"][None, :, None]
    y = y.reshape(B, din) * _silu_in_f32(z, x.dtype)
    return y @ p["wout_row"], (h_new, window[:, 1:, :])


def mamba2_param_shapes(cfg) -> dict:
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "wz_col": (cfg.d_model, din),
        "wx_col": (cfg.d_model, din),
        "wb": (cfg.d_model, N),
        "wc": (cfg.d_model, N),
        "wdt": (cfg.d_model, H),
        "conv_x": (cfg.ssm_conv, din),
        "conv_b": (cfg.ssm_conv, N),
        "conv_c": (cfg.ssm_conv, N),
        "dt_bias": (H,),
        "a_log": (H,),
        "d_skip": (H,),
        "wout_row": (din, cfg.d_model),
    }


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory — SSD machinery) and sLSTM (sequential)
# ---------------------------------------------------------------------------


def _mlstm_gates(x: torch.Tensor, p: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(log forget ≤ 0, exponential input gate) in float32, (..., H) each."""
    gates = (x @ p["wgate_col"]).to(torch.float32)
    i_g, f_g = torch.chunk(gates, 2, dim=-1)
    return -F.softplus(-f_g), torch.exp(torch.clamp(i_g, -30.0, 8.0))


def mlstm_layer(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """mLSTM: h_t = f_t·h + i_t·(k_t ⊗ v_t); y_t = q_t·h_t (per head)."""
    B, S, D = x.shape
    H = cfg.n_heads
    P = D // H
    q, k, v = torch.chunk(x @ p["wqkv_col"], 3, dim=-1)  # (B,S,D) each
    f_log, i_s = _mlstm_gates(x, p)  # (B,S,H) each

    def heads(t):  # (B,S,H,P) -> (B*H,S,P): each head its own (N=P) basis
        return t.reshape(B, S, H, P).permute(0, 2, 1, 3).reshape(B * H, S, P)

    xf = heads(v)[:, :, None, :]  # (B*H,S,1,P)
    af = f_log.permute(0, 2, 1).reshape(B * H, S, 1)
    bf = heads(k) / (P ** 0.5)
    cf = heads(q)
    df = i_s.permute(0, 2, 1).reshape(B * H, S, 1)
    y, _ = ssd_chunked(xf, af, bf, cf, df, chunk=cfg.ssm_chunk)
    y = y.reshape(B, H, S, P).permute(0, 2, 1, 3)
    # normaliser: n_t = f·n + i·k; denominator |q·n|, the same SSD with x ≡ 1
    nrm, _ = ssd_chunked(torch.ones_like(xf[..., :1]), af, bf, cf, df, chunk=cfg.ssm_chunk)
    nrm = nrm.reshape(B, H, S, 1).permute(0, 2, 1, 3)
    y = y / torch.clamp(nrm.abs(), min=1.0)
    y = y.reshape(B, S, D) * _silu_in_f32(x @ p["wz_col"], x.dtype)
    return y @ p["wo_row"]


def mlstm_decode(p: dict, x: torch.Tensor, state, cfg):
    """x: (B,D); state: (h (B*H,1,P,P) f32, n (B*H,1,P,1) f32)."""
    B, D = x.shape
    H = cfg.n_heads
    P = D // H
    h, n = state
    q, k, v = torch.chunk(x @ p["wqkv_col"], 3, dim=-1)
    f_log, i_s = _mlstm_gates(x, p)
    vh = v.reshape(B * H, 1, P)
    kh = k.reshape(B * H, P) / (P ** 0.5)
    qh = q.reshape(B * H, P)
    af = f_log.reshape(B * H, 1)
    df = i_s.reshape(B * H, 1)
    h_new, y = ssd_decode_step(h, vh, af, kh, qh, df)
    n_new, nrm = ssd_decode_step(n, torch.ones_like(vh[..., :1]), af, kh, qh, df)
    y = y / torch.clamp(nrm.abs(), min=1.0)
    y = y.reshape(B, D) * _silu_in_f32(x @ p["wz_col"], x.dtype)
    return y @ p["wo_row"], (h_new, n_new)


def mlstm_param_shapes(cfg) -> dict:
    D = cfg.d_model
    return {
        "wqkv_col": (D, 3 * D),
        "wgate_col": (D, 2 * cfg.n_heads),
        "wz_col": (D, D),
        "wo_row": (D, D),
    }


def _slstm_cell(p: dict, zt: torch.Tensor, state, H: int, P: int, dtype):
    """One sLSTM step from the input projection zt (B,4D) and the state
    (c, n, m (B,D) f32, y_prev (B,H,P)): returns (y (B,D), the new state).
    Head h's previous output feeds head h's gate slices through r_dp."""
    c, n, m, y_prev = state
    B = zt.shape[0]
    D = H * P
    rec = torch.einsum("bhp,hpq->bhq", y_prev, p["r_dp"])  # (B,H,4P)
    rec = rec.reshape(B, H, 4, P).permute(0, 2, 1, 3).reshape(B, 4 * D)
    z, i_g, f_g, o = torch.chunk((zt + rec).to(torch.float32), 4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o)
    log_f = -F.softplus(-f_g)
    m_new = torch.maximum(log_f + m, i_g)
    i_s = torch.exp(torch.clamp(i_g - m_new, -30.0, 0.0))
    f_s = torch.exp(torch.clamp(log_f + m - m_new, -30.0, 0.0))
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    y = (o * c_new / torch.clamp(n_new, min=1.0)).to(dtype)
    return y, (c_new, n_new, m_new, y.reshape(B, H, P))


def slstm_layer(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """sLSTM: scalar-memory LSTM with exponential gating and per-head
    recurrent mixing; a sequential loop over time (inherently recurrent)."""
    B, S, D = x.shape
    H = cfg.n_heads
    P = D // H
    zifo = x @ p["wzifo_col"]  # (B,S,4D)
    c0 = torch.zeros((B, D), dtype=torch.float32, device=x.device)
    state = (c0, c0, torch.full((B, D), -30.0, device=x.device),
             torch.zeros((B, H, P), dtype=x.dtype, device=x.device))
    cell = _recorded(_slstm_cell) if _recording(x, *p.values()) else _slstm_cell
    ys = []
    for t in range(S):
        y, state = cell(p, zifo[:, t], state, H, P, x.dtype)
        ys.append(y)
    return torch.stack(ys, dim=1) @ p["wo_row"]


def slstm_decode(p: dict, x: torch.Tensor, state, cfg):
    """x: (B,D); state: (c, n, m (B,D) f32, y_prev (B,H,P))."""
    D = x.shape[1]
    H = cfg.n_heads
    y, state = _slstm_cell(p, x @ p["wzifo_col"], state, H, D // H, x.dtype)
    return y @ p["wo_row"], state


def slstm_param_shapes(cfg) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    P = D // H
    return {
        "wzifo_col": (D, 4 * D),
        "r_dp": (H, P, 4 * P),
        "wo_row": (D, D),
    }
