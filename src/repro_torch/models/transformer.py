"""Transformer stacks: parameter shape trees, the decoder's training
forward, prefill and one decode step (dense, moe and vlm), and whisper's
encoder and its cross-attention decoder's training forward.

The reference scans one traced layer body over the stacked parameter tree;
here each stack is a Python loop over the same stacked leaves, layer ``l``
reading the views ``w[l]``. A moe layer's MLP is :func:`moe_ffn`. The
enc-dec decoder's prefill and decode step live with their family in
``models/zoo.py``, as in the reference; its training forward is
:func:`encdec_decoder_forward` here.

Two ways over a mesh, chosen by the parameters:

* plain (replicated) parameters with ``mesh=``: the data-parallel path,
  its collectives explicit (the vocab-sharded :func:`embed_lookup` over
  ``torch.distributed``, ``make_train_step(model, mesh)``);
* parameters placed by ``shardings_for`` (DTensors, the mesh theirs): the
  dense and vlm stacks run on DTensors, each layer's parameters gathered
  over the data axes (ZeRO-3) and sharded over ``model`` (TP), the
  residual stream sharded over ``model`` between layers under
  ``act_shard="seq"``, the prefill's and decode's caches laid out as the
  reference's ``input_spec_for`` lays them (:func:`cache_like`). Such a
  call takes no ``mesh=``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.collectives import (
    all_gather_rows,
    axis_group,
    axis_index,
    axis_size,
    data_axes,
    data_shards,
    has_axis,
)
from repro_torch.models import layers as L
from repro_torch.models.base import ArchConfig, Sharding, from_local
from repro_torch.models.moe import moe_ffn, moe_param_shapes


# ---------------------------------------------------------------------------
# Param shape trees
# ---------------------------------------------------------------------------


def attn_param_shapes(cfg: ArchConfig) -> dict:
    D, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {
        "wq_col": (D, H * hd),
        "wk_col": (D, KH * hd),
        "wv_col": (D, KH * hd),
        "wo_row": (H * hd, D),
    }
    if cfg.qkv_bias:
        s.update({"bq_col": (H * hd,), "bk_col": (KH * hd,), "bv_col": (KH * hd,)})
    return s


def mlp_param_shapes(cfg: ArchConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.mlp_act == "silu_gated":
        return {"wg_col": (D, F), "wu_col": (D, F), "wd_row": (F, D)}
    return {"wu_col": (D, F), "wd_row": (F, D)}


def decoder_layer_shapes(cfg: ArchConfig, cross: bool = False) -> dict:
    """A decoder layer; ``cross`` adds the enc-dec cross-attention's norm
    (``ln_x``) and projections (``xattn``)."""
    s = {
        "ln1": (cfg.d_model,),
        "ln2": (cfg.d_model,),
        "attn": attn_param_shapes(cfg),
    }
    if cross:
        s["ln_x"] = (cfg.d_model,)
        s["xattn"] = attn_param_shapes(cfg)
    if cfg.family == "moe":
        s["moe"] = moe_param_shapes(cfg)
    else:
        s["mlp"] = mlp_param_shapes(cfg)
    return s


def _ffn(lp: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The layer's MLP on (B, S, D): experts in a moe layer, else dense."""
    if cfg.family == "moe":
        return moe_ffn(lp["moe"], h, cfg)
    return L.mlp_block(lp["mlp"], h, cfg)


def stack_shapes(layer_shapes: dict, n: int) -> dict:
    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        return (n, *t)

    return rec(layer_shapes)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter tree: views, no copies."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def n_stacked(stacked: dict) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


# ---------------------------------------------------------------------------
# Embedding with vocab sharding
# ---------------------------------------------------------------------------


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """``embed[tokens]``. With a mesh that has a ``model`` axis, the
    reference's vocab-sharded lookup: each rank looks the tokens up in its
    ``V / m`` row slice of the (replicated) table, zeroes the misses and
    SUM all-reduces over the model group. The batch is split over the data
    axes where it divides them (not the B = 1 decode cells) and gathered
    back, so every rank returns the whole (B, S, D) lookup, as the
    reference's ``shard_map`` does. The collectives carry no gradient:
    training takes each rank's batch slice through ``make_train_step(model,
    mesh)``, whose loss runs without a mesh.

    A DTensor ``embed`` (placed by ``shardings_for``: vocab rows over
    ``model``) takes :func:`_embed_sharded` and no ``mesh``."""
    if L.sharded(embed):
        if mesh is not None:
            raise ValueError("sharded parameters carry their mesh: pass no mesh=")
        return _embed_sharded(embed, tokens)
    if not has_axis(mesh, "model"):
        return L.embed_tokens(embed, tokens)
    if torch.is_grad_enabled() and embed.requires_grad:
        raise ValueError("the vocab-sharded lookup has no backward: train through "
                         "make_train_step(model, mesh)")
    m, V = axis_size(mesh, "model"), embed.shape[0]
    if V % m:
        raise ValueError(f"a vocab of {V} rows does not split over the {m} ranks of 'model'")
    Vl = V // m
    lo = axis_index(mesh, "model") * Vl
    axes = data_axes(mesh)
    i, d = data_shards(mesh)
    B = tokens.shape[0]
    split = B % d == 0 and d > 1
    t = tokens[i * B // d:(i + 1) * B // d] if split else tokens
    ids = t - lo
    ok = (ids >= 0) & (ids < Vl)
    out = L.embed_tokens(embed[lo:lo + Vl], torch.clamp(ids, 0, Vl - 1))
    out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    dist.all_reduce(out, group=axis_group(mesh, "model"))
    return all_gather_rows(out, mesh, axes) if split else out


def _embed_sharded(embed: DTensor, tokens) -> DTensor:
    """The vocab-sharded lookup on DTensors, differentiable: each rank
    looks its batch shard of ``tokens`` up in its ``V / m`` rows of
    ``embed``, zeroes the misses, and the (B, S, D) result, a partial sum
    over ``model``, is all-reduced there. The local table's gradient is
    partial over the data axes (each rank saw its batch shard only), and is
    summed when the train step lays it out as the parameter (over the axes
    the tokens are sharded on). A table the rules left replicated is an
    ordinary lookup."""
    mesh = embed.device_mesh
    if not L.sharded(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    md = L.mesh_dim(mesh, "model")
    if md is None or embed.placements[md] != Shard(0):
        return F.embedding(tokens, embed)
    tokens = L.with_placements(tokens, model=Replicate())
    V, m = embed.shape[0], mesh.size(md)
    Vl = V // m
    lo = mesh.get_local_rank(md) * Vl
    grad_pl = [Partial() if p == Replicate() and t.is_shard() else p
               for p, t in zip(embed.placements, tokens.placements)]
    e = embed.to_local(grad_placements=grad_pl)
    ids = tokens.to_local() - lo
    ok = (ids >= 0) & (ids < Vl)
    out = L.embed_tokens(e, torch.clamp(ids, 0, Vl - 1))
    out = torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    pl = list(tokens.placements)
    pl[md] = Partial()
    out = from_local(out, mesh, pl, (*tokens.shape, embed.shape[1]))
    return L.with_placements(out, model=Replicate())


def cache_like(name: str, shape, dtype, like: DTensor) -> DTensor:
    """Zeros of ``shape`` laid out as the reference's ``input_spec_for``
    lays cache ``name`` on ``like``'s mesh: a DTensor whose every rank
    holds its zeroed shard."""
    from repro_torch.launch.shardings import input_spec_for

    mesh = like.device_mesh
    sh = Sharding(mesh, input_spec_for(name, tuple(shape), mesh))
    local = torch.zeros(sh.shard_shape(shape), dtype=dtype, device=like.device)
    return from_local(local, mesh, sh.placements, shape)


def _cache_layout(cache: DTensor) -> tuple:
    """(the batch's placement, the new rows' placement over ``model``,
    whether the sequence is sharded over ``model``) of a stacked (L, B, S,
    KH, hd) cache laid out by ``input_spec_for``."""
    mesh = cache.device_mesh
    md = L.mesh_dim(mesh, "model")
    over_model = cache.placements[md] if md is not None else Replicate()
    bp = Shard(0) if Shard(1) in cache.placements else Replicate()
    return bp, Shard(2) if over_model == Shard(3) else Replicate(), over_model == Shard(2)


def write_prompt(cache: DTensor, i: int, k: DTensor) -> None:
    """``cache[i, :, :S] = k`` (k: (B, S, KH, hd)) on each rank's shard of
    the cache: its batch rows, its heads or its chunk of the sequence."""
    bp, kp, seq = _cache_layout(cache)
    kl = L.with_placements(k, data=bp, model=kp).to_local()
    cl = cache.to_local()
    C = cl.shape[2]
    lo = cache.device_mesh.get_local_rank("model") * C if seq else 0
    n = max(0, min(C, k.shape[1] - lo))
    cl[i, :, :n] = kl[:, lo:lo + n]


def write_step(cache: DTensor, i: int, k: DTensor, pos) -> None:
    """``cache[i][b, pos[b]] = k[b, 0]`` on each rank's shard; over a
    sequence sharded over ``model`` each rank writes the rows that fall in
    its chunk and keeps the others."""
    bp, kp, seq = _cache_layout(cache)
    kl = L.with_placements(k, data=bp, model=kp).to_local()[:, 0]
    pl = L.with_placements(pos, data=bp, model=Replicate()).to_local()
    cl = cache.to_local()[i]
    rows = torch.arange(cl.shape[0], device=cl.device)
    if not seq:
        cl[rows, pl] = kl
        return
    C = cl.shape[1]
    lo = cache.device_mesh.get_local_rank("model") * C
    at = torch.clamp(pl - lo, 0, C - 1)
    mine = ((pl >= lo) & (pl < lo + C))[:, None, None]
    cl[rows, at] = torch.where(mine, kl, cl[rows, at])


# ---------------------------------------------------------------------------
# Dense decoder: training forward, prefill and decode
# ---------------------------------------------------------------------------


def _layer_fwd(lp: dict, h: torch.Tensor, cfg: ArchConfig, positions, causal: bool,
               window: int) -> torch.Tensor:
    # sharded: the parameters gathered over the data axes, the sequence at entry
    lp, h = L.gather_data(lp), L.seq_gather(h, cfg)
    a = L.attn_block(lp["attn"], L.rmsnorm(h, lp["ln1"], cfg.norm_eps), cfg,
                     positions=positions, causal=causal, window=window, train=True)
    h = h + a
    return L.seq_shard(h + _ffn(lp, L.rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg), cfg)


def decoder_forward(
    layers_params: dict,
    h: torch.Tensor,
    cfg: ArchConfig,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """The training forward: every layer on :func:`L.attention_train`
    (differentiable; the kernels have no backward), each under
    ``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
    ``jax.checkpoint`` on its scan body), so the backward keeps one
    (B, S, D) input a layer. On DTensors the sequence is sharded over
    ``model`` between layers (:func:`L.seq_shard`, the reference's; a no-op
    unless ``cfg.act_shard == "seq"``), gathered at a layer's entry."""
    h = L.seq_shard(h, cfg)
    for i in range(n_stacked(layers_params)):
        lp = layer_params(layers_params, i)
        if cfg.remat:
            h = checkpoint(_layer_fwd, lp, h, cfg, positions, causal, window,
                           use_reentrant=False)
        else:
            h = _layer_fwd(lp, h, cfg, positions, causal, window)
    return h


def decoder_prefill(
    layers_params: dict,
    h: torch.Tensor,
    cfg: ArchConfig,
    *,
    positions: torch.Tensor,
    cache_len: int,
    window: int = 0,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Forward + emit per-layer K/V caches padded to cache_len:
    (L, B, cache_len, KH, hd) each, zero past the prompt."""
    B, S, _ = h.shape
    KH, hd = cfg.n_kv_heads, cfg.hd
    n_layers = n_stacked(layers_params)
    shape = (n_layers, B, cache_len, KH, hd)
    if L.sharded(h):
        kcs, vcs = cache_like("k_cache", shape, h.dtype, h), cache_like("v_cache", shape, h.dtype, h)
    else:
        kcs = torch.zeros(shape, dtype=h.dtype, device=h.device)
        vcs = torch.zeros_like(kcs)
    for i in range(n_layers):
        lp = L.gather_data(layer_params(layers_params, i))
        hn = L.rmsnorm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = L.attn_proj_qkv(lp["attn"], hn, cfg)
        if cfg.rope_theta > 0:
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
        # caches keep the original KH heads; expansion is attention-local
        qe, ke, ve, Hr = L.expand_heads_for_tp(q, k, v, cfg)
        att = L.attention_chunked(qe, ke, ve, causal=True, window=window)
        att = att[:, :, :Hr].reshape(B, S, cfg.n_heads * hd)
        h = h + L.settle(att @ lp["attn"]["wo_row"])
        hn2 = L.rmsnorm(h, lp["ln2"], cfg.norm_eps)
        h = h + _ffn(lp, hn2, cfg)
        if L.sharded(h):
            write_prompt(kcs, i, k)
            write_prompt(vcs, i, v)
        else:
            kcs[i, :, :S] = k
            vcs[i, :, :S] = v
    return h, (kcs, vcs)


def decoder_decode_step(
    layers_params: dict,
    h: torch.Tensor,  # (B, D) one token's hidden
    kv_caches: tuple[torch.Tensor, torch.Tensor],  # (L,B,S,KH,hd) ×2
    lengths: torch.Tensor,  # (B,)
    cfg: ArchConfig,
    *,
    window: int = 0,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One token for every sequence. The new K/V rows go into the caches in
    place, at each sequence's ``lengths`` (the reference's jit donates the
    cache buffers and writes a new array; the port writes into the same
    tensors and returns them)."""
    B = h.shape[0]
    kcs, vcs = kv_caches
    pos = lengths  # 0-based position of the new token
    valid = L.decode_rows(lengths, kcs.shape[2])  # the new row included; raises if full
    rows = torch.arange(B, device=h.device)
    for i in range(n_stacked(layers_params)):
        lp = L.gather_data(layer_params(layers_params, i))
        kc, vc = kcs[i], vcs[i]
        hn = L.rmsnorm(h, lp["ln1"], cfg.norm_eps)[:, None, :]  # (B,1,D)
        q, k, v = L.attn_proj_qkv(lp["attn"], hn, cfg)
        if cfg.rope_theta > 0:
            q = L.rope(q, pos[:, None], cfg.rope_theta)
            k = L.rope(k, pos[:, None], cfg.rope_theta)
        if L.sharded(h):
            write_step(kcs, i, k, pos)
            write_step(vcs, i, v, pos)
        else:
            kc[rows, pos] = k[:, 0]
            vc[rows, pos] = v[:, 0]
        att = L.attention_decode(q[:, 0], kc, vc, valid, window=window)
        h = h + L.settle(att.reshape(B, -1) @ lp["attn"]["wo_row"])
        hn2 = L.rmsnorm(h, lp["ln2"], cfg.norm_eps)
        h = h + _ffn(lp, hn2[:, None, :], cfg)[:, 0]
    return h, (kcs, vcs)


# ---------------------------------------------------------------------------
# Encoder stack (whisper) and the cross-attention decoder's training forward
# ---------------------------------------------------------------------------


def _encoder_layer(lp: dict, h: torch.Tensor, cfg: ArchConfig, positions,
                   train: bool) -> torch.Tensor:
    h = h + L.attn_block(lp["attn"], L.rmsnorm(h, lp["ln1"], cfg.norm_eps), cfg,
                         positions=positions, causal=False, train=train)
    return h + L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg)


def encoder_forward(layers_params: dict, h: torch.Tensor, cfg: ArchConfig,
                    positions: torch.Tensor, train: bool = False) -> torch.Tensor:
    """Pre-norm layers of non-causal self-attention (RoPE at ``positions``
    where ``rope_theta`` > 0, as the reference's ``attn_block``) and an MLP:
    the prefill's on the flash-attention kernel, or with ``train`` on the
    differentiable :func:`L.attention_train`, each layer then under
    ``torch.utils.checkpoint`` when ``cfg.remat`` (the reference's
    ``jax.checkpoint`` on its scan body)."""
    remat = train and cfg.remat
    for i in range(n_stacked(layers_params)):
        lp = layer_params(layers_params, i)
        if remat:
            h = checkpoint(_encoder_layer, lp, h, cfg, positions, train, use_reentrant=False)
        else:
            h = _encoder_layer(lp, h, cfg, positions, train)
    return h


def _train_cross_query(p: dict, hn: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The training forward's cross-attention query: ``hn @ wq_col`` plus
    ``bq_col`` when ``cfg.qkv_bias``, no RoPE. The reference's prefill and
    decode add no bias (``models/zoo.py``'s ``_cross_query``); each path
    keeps its own."""
    q = hn @ p["wq_col"]
    if cfg.qkv_bias:
        q = q + p["bq_col"]
    return q.reshape(*hn.shape[:-1], cfg.n_heads, cfg.hd)


def _cross_attention(p: dict, hn: torch.Tensor, enc_out: torch.Tensor,
                     cfg: ArchConfig) -> torch.Tensor:
    """One layer's cross-attention on the training path: K/V projected from
    the encoder's rows (biases, no RoPE), the query of
    :func:`_train_cross_query`, :func:`L.attention_train` over every
    encoder row (its padded keys masked), then ``wo_row``. The reference
    projects the K/V with ``attn_proj_qkv`` and drops its query;
    ``attn_proj_kv`` computes the same K and V."""
    B, S, _ = hn.shape
    xk, xv = L.attn_proj_kv(p, enc_out, cfg)
    att = L.attention_train(_train_cross_query(p, hn, cfg), xk, xv, causal=False)
    return att.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo_row"]


def _encdec_layer(lp: dict, h: torch.Tensor, enc_out: torch.Tensor, cfg: ArchConfig,
                  positions) -> torch.Tensor:
    h = h + L.attn_block(lp["attn"], L.rmsnorm(h, lp["ln1"], cfg.norm_eps), cfg,
                         positions=positions, causal=True, train=True)
    h = h + _cross_attention(lp["xattn"], L.rmsnorm(h, lp["ln_x"], cfg.norm_eps), enc_out, cfg)
    return h + L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg)


def encdec_decoder_forward(
    layers_params: dict,
    h: torch.Tensor,
    enc_out: torch.Tensor,
    cfg: ArchConfig,
    *,
    positions: torch.Tensor,
    enc_positions: torch.Tensor,
) -> torch.Tensor:
    """The enc-dec decoder's training forward (the reference's): each layer
    causal self-attention with RoPE at ``positions``, cross-attention over
    ``enc_out`` (:func:`_cross_attention`), the MLP, all on
    :func:`L.attention_train`; each layer under ``torch.utils.checkpoint``
    when ``cfg.remat``. ``enc_positions`` is unused, as in the reference's
    body: the cross K/V take no RoPE. It stays for the reference's
    signature."""
    for i in range(n_stacked(layers_params)):
        lp = layer_params(layers_params, i)
        if cfg.remat:
            h = checkpoint(_encdec_layer, lp, h, enc_out, cfg, positions, use_reentrant=False)
        else:
            h = _encdec_layer(lp, h, enc_out, cfg, positions)
    return h
