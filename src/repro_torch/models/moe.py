"""Mixture-of-experts layer: GShard-style capacity dispatch, block-chunked.

The port of the reference's ``moe_ffn``, in plain PyTorch: the router, the
dispatch and the expert products are ``matmul``/``einsum``/``bmm`` (the
reference computes them outside any Pallas kernel too). Tokens are processed
in blocks of ``tb`` sequence positions × the whole batch, a Python loop over
the blocks where the reference scans them, so the dispatch one-hot stays
O(tb · E · C).

It drops the same (token, k) assignments as the reference:

* each (token, k)'s position in its expert's buffer is a cumsum over the
  flattened ``(tb·K, E)`` one-hot, token-major then k; the capacity is
  ``C = max(4, round_up_4(ceil(tb·K / E_real · cf)))`` with the real expert
  count, not the padded one;
* the sequence is padded to a multiple of the block, and the pad tokens
  (and a decode tick's empty slots) are routed and take capacity as they do
  in the reference;
* padded experts (``moe_pad_experts``) get logits of -1e30 and never win;
* ties in the gates resolve to the lowest expert index, as
  ``jax.lax.top_k`` resolves them (a stable descending sort, its first K);
* the router runs in float32 after the product in the model's dtype, and
  the gate renormalisation has a 1e-9 floor;
* in a data-parallel step (:func:`sharded_batch`) each rank holds a
  contiguous slice of the batch, and the blocks, the capacity and the
  positions are those of the whole batch: a rank's positions start after
  the assignments the ranks before it made to each expert in the block
  (one all-gather of the per-expert counts a layer), so the ranks together
  drop what the reference's step, jitted over the whole batch, drops.

Every shape is static (the capacity is a Python int of the shapes), so a
decode tick through it stays one CUDA graph.

Variants (per config):
  * ``moe_dispatch="einsum"`` (default): one-hot dispatch/combine products;
  * ``moe_dispatch="scatter"``: each kept (token, k) owns slot
    ``expert·C + pos``; dispatch is a scatter, combine a gather, and every
    dropped assignment writes to the trash slot ``E·C``, whose value is
    discarded;
  * shared experts (qwen2-moe): always-on experts added to routed output;
  * dense residual (arctic): a dense FFN runs in parallel with the MoE.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import all_gather_rows, data_axes, data_shards

# (mesh, rows of the whole batch) while a data-parallel step runs, else None.
# A module setting, not a context variable: autograd's device thread, which
# recomputes a checkpointed layer in the backward, must read it too.
_sharded: tuple | None = None


@contextlib.contextmanager
def sharded_batch(mesh, rows: int):
    """Within it, every moe layer's input is this rank's contiguous slice
    of a batch of ``rows`` rows laid over ``mesh``'s data axes (pod-major),
    and the layer routes as the whole batch would (module docstring)."""
    global _sharded
    before, _sharded = _sharded, (mesh, rows)
    try:
        yield
    finally:
        _sharded = before


def _capacity(tb: int, k: int, E: int, cf: float) -> int:
    c = int(math.ceil(tb * k / E * cf))
    return max(4, ((c + 3) // 4) * 4)


def _blocks(x: torch.Tensor, token_block: int, rows: int | None = None) -> tuple[torch.Tensor, int]:
    """(B, S, D) -> (nb, B·sb, D): sequence-major blocks of ``sb`` positions
    with the batch kept, the sequence zero-padded to a multiple of ``sb``;
    ``sb`` is sized for a batch of ``rows`` (B unless a rank holds a slice).
    Returns the blocks and ``sb``."""
    B, S, D = x.shape
    sb = max(1, min(token_block // (rows or B), S))  # seq positions per block
    pad = (-S) % sb
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    nb = x.shape[1] // sb
    return x.reshape(B, nb, sb, D).transpose(0, 1).reshape(nb, B * sb, D), sb


def _top_k(xb: torch.Tensor, wr: torch.Tensor, E_real: int, K: int):
    """The router: each token's K gates (renormalised, float32) and experts."""
    E = wr.shape[1]
    logits = (xb @ wr).float()
    if E > E_real:  # padded experts can never win the top-k
        logits = logits.masked_fill(
            torch.arange(E, device=xb.device) >= E_real, -1e30)
    gates = torch.softmax(logits, dim=-1)
    # the first K of a stable descending sort: ties go to the lower index
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :K], topi[:, :K]
    return topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9), topi


def _route(xb: torch.Tensor, wr: torch.Tensor, E_real: int, K: int, C: int, before=None):
    """Router + each (token, k)'s position in its expert's capacity buffer,
    after ``before[e]`` assignments made to expert e elsewhere (the ranks
    before this one; none without). Returns (gates (tb,K) float32, experts
    (tb,K), positions (tb,K), kept)."""
    E = wr.shape[1]
    topv, topi = _top_k(xb, wr, E_real, K)
    flat = F.one_hot(topi, E).reshape(-1, E)  # (tb·K, E), token-major then k
    # the count runs down each expert's column; scanned as rows of the
    # transpose (an integer sum: the order changes nothing)
    pos_in_e = torch.cumsum(flat.t().contiguous(), dim=1).t() - flat
    if before is not None:
        pos_in_e = pos_in_e + before
    pos = (pos_in_e * flat).sum(-1).reshape(topi.shape)
    return topv, topi, pos, pos < C


def _counts_before(xt: torch.Tensor, wr: torch.Tensor, E_real: int, K: int, mesh) -> torch.Tensor:
    """(nb, E): the assignments the ranks before this one (along the data
    axes, pod-major) make to each expert in each block."""
    E = wr.shape[1]
    with torch.no_grad():
        mine = torch.stack([F.one_hot(_top_k(xb, wr, E_real, K)[1], E).sum((0, 1))
                            for xb in xt])
    every = all_gather_rows(mine[None], mesh, data_axes(mesh))  # (ranks, nb, E)
    return every[: data_shards(mesh)[0]].sum(0)


def _experts(xe: torch.Tensor, w1, w2, w3) -> torch.Tensor:
    """(E,C,D) -> (E,C,D) expert FFNs."""
    g = torch.bmm(xe, w1)
    u = torch.bmm(xe, w3)
    h = F.silu(g.float()).to(xe.dtype) * u
    return torch.bmm(h, w2)


def _block_einsum(xb, p, E_real, K, C, before=None):
    """GShard one-hot dispatch and combine."""
    w1, w2, w3 = p["w1_exp"], p["w2_exp"], p["w3_exp"]
    E = w1.shape[0]
    topv, topi, pos, keep = _route(xb, p["router_col"], E_real, K, C, before)
    dt = xb.dtype
    disp = (
        F.one_hot(topi, E).to(dt)[..., None]
        * F.one_hot(torch.where(keep, pos, C), C + 1).to(dt)[:, :, None, :]
    )[..., :C]  # (tb,K,E,C)
    disp_t = disp.sum(1)  # (tb,E,C)
    xe = torch.einsum("tec,td->ecd", disp_t, xb)  # (E,C,D)
    ye = _experts(xe, w1, w2, w3)
    comb = (disp * topv.to(dt)[..., None, None]).sum(1)  # (tb,E,C)
    return torch.einsum("tec,ecd->td", comb, ye)


def _block_scatter(xb, p, E_real, K, C, before=None):
    """Sort-free scatter/gather dispatch: O(tb·K·D) bytes, no dispatch
    products."""
    w1, w2, w3 = p["w1_exp"], p["w2_exp"], p["w3_exp"]
    E = w1.shape[0]
    tb, D = xb.shape
    topv, topi, pos, keep = _route(xb, p["router_col"], E_real, K, C, before)
    slot = torch.where(keep, topi * C + pos, E * C)  # (tb,K); E*C = trash
    tok = torch.arange(tb, device=xb.device)[:, None].expand(tb, K)
    buf = torch.zeros((E * C + 1, D), dtype=xb.dtype, device=xb.device)
    buf[slot.reshape(-1)] = xb[tok.reshape(-1)]
    ye = _experts(buf[: E * C].reshape(E, C, D), w1, w2, w3)
    ye_flat = torch.cat([ye.reshape(E * C, D), ye.new_zeros((1, D))])
    gathered = ye_flat[slot]  # (tb,K,D)
    w = torch.where(keep, topv, 0.0).to(xb.dtype)
    return (gathered * w[..., None]).sum(1)


def _gated_ffn(x, w1, w3, w2):
    g = x @ w1
    u = x @ w3
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w2


def moe_ffn(p: dict, x: torch.Tensor, cfg, token_block: int = 4096) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D). p holds router + expert weights (experts
    possibly padded: E is ``w1_exp``'s leading dim)."""
    B, S, D = x.shape
    E_real, K = cfg.moe_experts, cfg.moe_top_k
    mesh, rows = _sharded or (None, B)
    if mesh is not None and B * data_shards(mesh)[1] != rows:
        raise ValueError(f"a slice of {B} rows is not one of {data_shards(mesh)[1]} "
                         f"equal slices of the {rows} rows the step shards")
    xt, sb = _blocks(x, token_block, rows)
    nb = xt.shape[0]
    C = _capacity(rows * sb, K, E_real, cfg.moe_capacity_factor)
    before = (_counts_before(xt, p["router_col"], E_real, K, mesh) if mesh is not None
              else [None] * nb)
    block = (
        _block_scatter
        if getattr(cfg, "moe_dispatch", "einsum") == "scatter"
        else _block_einsum
    )
    ys = torch.stack([block(xt[i], p, E_real, K, C, before[i]) for i in range(nb)])
    # (nb, B*sb, D) -> (B, Sp, D) -> strip seq padding
    y = ys.reshape(nb, B, sb, D).transpose(0, 1).reshape(B, nb * sb, D)[:, :S]
    if cfg.moe_shared_experts:
        y = y + _gated_ffn(x, p["ws1_col"], p["ws3_col"], p["ws2_row"])
    if cfg.moe_dense_residual:
        y = y + _gated_ffn(x, p["wr1_col"], p["wr3_col"], p["wr2_row"])
    return y


def route(p: dict, x: torch.Tensor, cfg,
          token_block: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """The routing ``moe_ffn`` makes on ``x``, pad tokens included: each
    (token, k)'s expert and whether capacity kept it, both (nb, tb, K) in
    the blocks' token order."""
    xt, _ = _blocks(x, token_block)
    C = _capacity(xt.shape[1], cfg.moe_top_k, cfg.moe_experts,
                  cfg.moe_capacity_factor)
    routes = [_route(xb, p["router_col"], cfg.moe_experts, cfg.moe_top_k, C)
              for xb in xt]
    return (torch.stack([r[1] for r in routes]),
            torch.stack([r[3] for r in routes]))


def moe_param_shapes(cfg) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    # expert dim padded at the parameter level; the router masks the padding
    E = max(cfg.moe_experts, getattr(cfg, "moe_pad_experts", 0) or 0)
    shapes = {
        "router_col": (D, E),
        "w1_exp": (E, D, F_),
        "w2_exp": (E, F_, D),
        "w3_exp": (E, D, F_),
    }
    if cfg.moe_shared_experts:
        Fs = cfg.moe_shared_d_ff
        shapes.update(
            {"ws1_col": (D, Fs), "ws2_row": (Fs, D), "ws3_col": (D, Fs)}
        )
    if cfg.moe_dense_residual:
        shapes.update(
            {"wr1_col": (D, F_), "wr2_row": (F_, D), "wr3_col": (D, F_)}
        )
    return shapes
