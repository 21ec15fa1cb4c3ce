"""Core layers of the LM zoo: norms, RoPE, attention, MLPs, embeddings.

The reference package's layers, on the same layouts: activations (B,S,D),
heads (B,S,H,D), caches (B,S,KH,D), weights (in, out) under leaf names that
carry the reference's sharding convention (``*_col``, ``*_row``). bf16 is
rounded where the reference rounds it: ``rmsnorm`` normalises in float32,
casts, then scales by the weight in the storage type; ``rope`` computes in
float32 and casts back; the MLP's activation runs in float32.

Attention runs on the hand-written kernels through
:mod:`repro_torch.kernels.ops`: :func:`attention_chunked` (the reference's
two-level online-softmax form, its "XLA analog of the Pallas flash kernel")
calls ``flash_attention_op`` and :func:`attention_decode` calls
``decode_attention_op``. The kernels compute the function of the reference's
oracles, whose softmax weights stay in float32; the reference's
``attention_chunked`` and ``attention_decode`` round q·scale to the cache
type and the weights to v's type first. The two agree in float32.

Training runs on neither kernel: they have no backward, and refuse inputs
that require grad. The reference trains through its XLA
``attention_chunked``, not through its Pallas kernel; the port's
:func:`attention_train` is that function in torch, on both devices, and
autograd gives its backward (``attn_block(..., train=True)`` reaches it).
:func:`xent_loss_chunked` is the reference's sequence-chunked loss.

Parameters placed by :func:`repro_torch.models.base.shardings_for` are
DTensors, and every layer here then runs on DTensors: the matmuls and
norms by DTensor's own sharding propagation, which inserts the
collectives, and attention on each rank's shard (:func:`attend_sharded`).
Where the reference lets XLA reshard silently, the port redistributes
explicitly: a projection whose head count the ``model`` axis does not
divide is replicated over ``model`` before its head reshape
(:func:`split_heads`), the residual stream's sequence is sharded and
gathered at a layer's exit and entry under ``act_shard="seq"``
(:func:`seq_shard`, :func:`seq_gather`), and a layer's parameters are
gathered over the data axes when the layer runs (:func:`gather_data`,
ZeRO-3).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.collectives import DATA_AXES, axis_size, has_axis
from repro_torch.kernels.attention import check_lengths
from repro_torch.models.base import from_local
from repro_torch.kernels.ops import decode_attention_op, flash_attention_op

_DECODE_WINDOW_TODO = (
    "a sliding window in decode attention: no config reaches it (zamba2's "
    "decode keeps a ring buffer of window rows and passes none); the decode "
    "kernel takes no window (ROADMAP Queue 1 item 10)"
)
NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) rotary over last dim; positions: (..., S)."""
    D = x.shape[-1]
    half = D // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Sharded parameters: layouts of DTensor activations
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def replicate_plain():
    """DTensor's ``implicit_replication``, nesting: inside, a plain tensor
    met with DTensors (the positions, RoPE's tables, the optimizer's
    scalars) stands replicated, being the same on every rank. The
    library's context resets the switch when any nested use of it exits,
    backward passes and outer calls included; this one restores it."""
    d = DTensor._op_dispatcher
    prev = d._allow_implicit_replication
    d._allow_implicit_replication = True
    try:
        yield
    finally:
        d._allow_implicit_replication = prev


def sharded(t) -> bool:
    """Whether ``t`` is a DTensor (parameters placed by ``shardings_for``)."""
    return isinstance(t, DTensor)


def mesh_dim(mesh, name: str):
    """The index of mesh axis ``name``, or None."""
    return mesh.mesh_dim_names.index(name) if has_axis(mesh, name) else None


def axis_ranks(mesh, name: str) -> int:
    """The ranks along axis ``name``: 1 for an axis the mesh lacks."""
    return axis_size(mesh, name) if has_axis(mesh, name) else 1


def with_placements(t: DTensor, **by_axis) -> DTensor:
    """``t`` redistributed with the placements of the named mesh axes
    replaced (``model=Replicate()``); ``data=`` covers ``pod`` too."""
    mesh = t.device_mesh
    pl = list(t.placements)
    for name, p in by_axis.items():
        for a in (DATA_AXES if name == "data" else (name,)):
            d = mesh_dim(mesh, a)
            if d is not None:
                pl[d] = p
    return t if tuple(pl) == tuple(t.placements) else t.redistribute(mesh, pl)


def gather_data(tree):
    """ZeRO-3: a layer's parameters (DTensor leaves) gathered over the data
    axes where they are sharded, kept sharded over ``model``; the gathers'
    backward reduce-scatters the gradients. Plain leaves pass as they are,
    and a tree of plain leaves is returned itself (its dicts' types kept)."""
    if isinstance(tree, dict):
        out = {k: gather_data(v) for k, v in tree.items()}
        return tree if all(out[k] is v for k, v in tree.items()) else out
    return with_placements(tree, data=Replicate()) if sharded(tree) else tree


def settle(t: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums reduced over ``model`` (an
    all-reduce), the activation replicated there and its batch over the
    data axes: the layout the residual stream keeps, so that DTensor does
    not carry partial sums on into the next layer's products. Plain
    tensors pass as they are."""
    if not sharded(t):
        return t
    return with_placements(t, data=batch_placement(t), model=Replicate())


class _GradAsValue(torch.autograd.Function):
    """Identity forward; the backward lays the gradient out as the value
    was (a partial sum reduced, a shard gathered)."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.layout) if sharded(g) else g


def grad_as_value(x: torch.Tensor) -> torch.Tensor:
    """``x``, its gradient laid out as ``x`` (a DTensor that autograd
    records; otherwise ``x`` itself). DTensor's backward keeps partial sums
    and shards where it can: at a tensor-parallel block's input (the
    column-parallel products after a norm) that is Megatron's *f*, the
    gradient all-reduced over ``model`` before the norm's backward, so it
    reaches the previous block's row-parallel products whole and DTensor
    does not gather their weights to meet a partial sum; after the merge of
    replicated heads, a gradient sharded over them would meet a reshape it
    cannot do."""
    if sharded(x) and x.requires_grad and torch.is_grad_enabled():
        return _GradAsValue.apply(x)
    return x


def seq_shard(h: torch.Tensor, cfg) -> torch.Tensor:
    """Megatron-SP: shard the residual stream's sequence dim over `model`
    between blocks (a DTensor (B, S, D) with S divisible), its batch over
    the data axes. No-op unless cfg.act_shard == 'seq'."""
    if not sharded(h) or getattr(cfg, "act_shard", "none") != "seq" or h.ndim != 3:
        return h
    if h.shape[1] % axis_ranks(h.device_mesh, "model"):
        return h
    return with_placements(h, data=batch_placement(h), model=Shard(1))


def seq_gather(h: torch.Tensor, cfg) -> torch.Tensor:
    """Megatron-SP companion: the sequence gathered at block entry so the
    block's matmuls see batch-sharded, sequence-replicated layouts. Plain
    tensors pass as they are."""
    if getattr(cfg, "act_shard", "none") != "seq" or h.ndim != 3:
        return h
    return settle(h)


def batch_placement(t: DTensor):
    """Shard(0) over the data axes where the batch divides them (the
    reference's ``P(dax, ...)`` with its divisibility guard); Replicate
    over data axes of one rank, where the two are the same layout and
    DTensor reshapes only the second."""
    mesh = t.device_mesh
    n = 1
    for a in DATA_AXES:
        n *= axis_ranks(mesh, a)
    return Shard(0) if n > 1 and t.shape[0] % n == 0 else Replicate()


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n·hd) → (..., n, hd). A DTensor whose last dim is sharded over
    ``model`` is first replicated there when ``model`` does not divide
    ``n`` (DTensor refuses that reshape, where XLA reshards silently), so
    its heads are then whole on every rank."""
    if sharded(t):
        d = mesh_dim(t.device_mesh, "model")
        if d is not None and t.placements[d] == Shard(t.ndim - 1) and n % t.device_mesh.size(d):
            t = with_placements(t, model=Replicate())
    return t.reshape(*t.shape[:-1], n, hd)


def place_heads(q, k, v, qd: int = 2, kd: int = 2, mha: bool = True):
    """q (…, H, D) and k, v (…, KH, D) DTensors (heads at dims ``qd`` and
    ``kd``) laid out for attention on each rank's shard: the batch over the
    data axes where it divides them; over ``model`` the heads by whole GQA
    groups where ``model`` divides KH, else (with ``mha``), where it
    divides H, K/V repeated to H heads (the MHA view, the repeat of
    ``expand_heads_for_tp``) and sharded alike, else replicated (a cache
    sharded over its sequence is then gathered)."""
    mesh = q.device_mesh
    m = axis_ranks(mesh, "model")
    H, KH = q.shape[qd], k.shape[kd]
    bp = batch_placement(q)
    if mha and m > 1 and KH % m and H % m == 0:
        k, v = (with_placements(t, data=bp, model=Replicate()) for t in (k, v))
        k, v = (torch.repeat_interleave(t, H // KH, dim=kd) for t in (k, v))
        KH = H
    by_heads = m > 1 and KH % m == 0
    q = with_placements(q, data=bp, model=Shard(qd) if by_heads else Replicate())
    k, v = (with_placements(t, data=bp, model=Shard(kd) if by_heads else Replicate())
            for t in (k, v))
    return q, k, v


def attend_sharded(fn, q, k, v, *rest, qd: int = 2, kd: int = 2, mha: bool = True):
    """``fn(q, k, v, *rest)`` (an attention over plain tensors) on each
    rank's shard of q, k, v placed by :func:`place_heads` (``rest``: plain
    arguments, or DTensors over the batch alone, like a decode's lengths);
    the output is a DTensor laid out as q. Every query head meets its KV
    heads on its rank, so the shards' attentions are the whole's; autograd
    flows through (``local_map``)."""
    q, k, v = place_heads(q, k, v, qd, kd, mha)
    mesh = q.device_mesh
    bp = batch_placement(q)
    rest = tuple(with_placements(r, data=bp, model=Replicate()) if sharded(r) else r
                 for r in rest)
    run = local_map(fn, out_placements=(tuple(q.placements),),
                    in_placements=(list(q.placements), list(k.placements), list(v.placements),
                                   *(list(r.placements) if sharded(r) else None for r in rest)),
                    redistribute_inputs=True, device_mesh=mesh)
    return run(q, k, v, *rest)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online-softmax attention on the flash-attention kernel.

    q: (B,Sq,H,D); k,v: (B,Skv,KH,D); GQA via H % KH == 0.
    q_offset: global position of q[0]. The kernel's causal mask and window
    put q[0] at Skv − Sq, so a causal or windowed call needs q_offset ==
    Skv − Sq (0 for a prefill over the whole sequence). ``window`` > 0 keeps
    key j for query i only if j > i + q_offset − window (the reference's
    ``_mask``). The reference's chunk sizes tile its XLA loops; the kernel
    tiles itself, so they have no counterpart.
    """
    Sq, Skv = q.shape[1], k.shape[1]
    if (causal or window > 0) and q_offset != Skv - Sq:
        raise NotImplementedError(
            f"causal or windowed attention with q_offset={q_offset} over Sq={Sq}, "
            f"Skv={Skv}: the kernel's mask is offset by Skv - Sq"
        )
    if sharded(q):
        return attend_sharded(lambda a, b, c: flash_attention_op(
            a, b, c, causal=causal, scale=scale, window=window), q, k, v)
    return flash_attention_op(q, k, v, causal=causal, scale=scale, window=window)


def _mask(q_pos, k_pos, causal: bool, window: int) -> torch.Tensor:
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    ok = kp <= qp if causal else torch.ones((q_pos.shape[0], k_pos.shape[0]),
                                            dtype=torch.bool, device=q_pos.device)
    if window > 0:
        ok = ok & (kp > qp - window)
    return ok


class _BlockMax(torch.autograd.Function):
    """Each query's largest score (B,KH,G,cq) over the block ``s``, with the
    gradient the reference's ``s.max`` passes back: to the score at the
    argmax key, that is to ``qf`` (B,cq,KH,G,D) through the key and to
    ``kf`` (B,ck,KH,D) at that key through the query, their float32 copies
    the scores were taken on. The argmax is found once, in the backward,
    and no gradient is made over the score block. A query whose every key
    is masked has a constant max and no gradient."""

    @staticmethod
    def forward(ctx, s, qf, kf):
        ctx.save_for_backward(s, qf, kf)
        return s.amax(dim=-1)

    @staticmethod
    def backward(ctx, g):
        s, qf, kf = ctx.saved_tensors
        B, cq, KH, G, D = qf.shape
        ck = kf.shape[1]
        at = s.argmax(dim=-1, keepdim=True)
        g = torch.where(s.gather(-1, at) == NEG_INF, 0.0, g[..., None])  # (B,KH,G,cq,1)
        kt = kf.permute(0, 2, 1, 3)  # (B,KH,ck,D)
        idx = at.reshape(B, KH, G * cq, 1).expand(-1, -1, -1, D)
        dq = g * kt.gather(2, idx).reshape(B, KH, G, cq, D)
        gq = (g * qf.permute(0, 2, 3, 1, 4)).reshape(-1, D)
        # index_put_ sums repeated keys in a fixed order (scatter_add_ on the
        # card does not), so a resumed run repeats a step's bits
        rows = (at.reshape(B * KH, G * cq)
                + ck * torch.arange(B * KH, device=s.device)[:, None]).reshape(-1)
        dk = kt.new_zeros(B * KH * ck, D).index_put_((rows,), gq, accumulate=True)
        return None, dq.permute(0, 3, 1, 2, 4), dk.reshape(B, KH, ck, D).permute(0, 2, 1, 3)


def _kv_step(m, l, acc, qb, kb, vb, q_pos, k_pos, Skv: int, causal: bool, window: int,
             masked: bool):
    """One KV block of the online softmax: the reference's ``kv_step``.
    qb (B,cq,KH,G,D) and kb, vb (B,ck,KH,D) in the storage type; the scores
    and sums in float32 (its ``preferred_element_type``). ``masked`` is
    False for a block whose every (query, key) pair the mask keeps: the
    reference's ``where`` changes nothing there. The gradient flows through
    the running max as in the reference (:class:`_BlockMax`). The
    output does not depend on the max in exact arithmetic, but in rounding
    its path takes back what the softmax's gradient leaves summed over a
    query's keys (P is rounded to v's type in the product, not in ``l``).
    Held constant, that residue, times a component every key shares, stays
    in the query's gradient: in bf16 over whisper's cross keys, which share
    their bias, the query's gradient erred 4x the reference's."""
    qf, kf = qb.float(), kb.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
    if masked:
        ok = _mask(q_pos, k_pos, causal, window) & (k_pos < Skv)[None, :]
        s = torch.where(ok, s, NEG_INF)
    m_new = torch.maximum(m, _BlockMax.apply(s.detach(), qf, kf))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
    return m_new, l_new, acc * alpha[..., None] + pv


def attention_train(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """The reference's ``attention_chunked``, differentiable: two-level
    online softmax over ``q_chunk`` query and ``k_chunk`` key blocks, GQA
    via H % KH == 0, the causal mask and window of its ``_mask``, padded
    keys masked by ``k_pos < Skv``. Each KV step runs under
    ``torch.utils.checkpoint`` (its ``jax.checkpoint``): the backward
    recomputes the block's scores, so a block's residency is its carry.

    q: (B,Sq,H,D); k,v: (B,Skv,KH,D); q_offset: global position of q[0].
    A block that the mask empties entirely is not computed: after the
    first block of a causal row (which always holds key 0) it would add
    exp(-1e30 - m) = 0 to every sum and scale them by exp(0) = 1, and
    before the first unmasked block of a window it would leave sums that
    the next block scales by exp(-1e30 - m) = 0, so the output and the
    gradient are those of the reference's full loop.
    """
    if sharded(q):
        return attend_sharded(lambda a, b, c: attention_train(
            a, b, c, causal=causal, window=window, scale=scale, q_chunk=q_chunk,
            k_chunk=k_chunk, q_offset=q_offset), q, k, v)
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    cq, ck = min(q_chunk, Sq), min(k_chunk, Skv)
    pq, pk = (-Sq) % cq, (-Skv) % ck
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = q.shape[1] // cq, k.shape[1] // ck
    qc = (q.float() * scale).to(k.dtype).reshape(B, nq, cq, KH, G, D)
    kc = k.reshape(B, nk, ck, KH, D)
    vc = v.reshape(B, nk, ck, KH, D)
    dev = q.device
    outs = []
    for iq in range(nq):
        lo, hi = q_offset + iq * cq, q_offset + iq * cq + cq - 1
        q_pos = lo + torch.arange(cq, device=dev)
        m = torch.full((B, KH, G, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KH, G, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KH, G, cq, D), dtype=torch.float32, device=dev)
        for jk in range(nk):
            k_lo = jk * ck
            if causal and k_lo > hi:  # every key after every query
                continue
            if window > 0 and k_lo + ck - 1 <= lo - window:  # every key out of every window
                continue
            k_hi = k_lo + ck - 1
            masked = ((causal and k_hi > lo) or (window > 0 and k_lo <= hi - window)
                      or k_hi >= Skv)
            k_pos = k_lo + torch.arange(ck, device=dev)
            m, l, acc = checkpoint(_kv_step, m, l, acc, qc[:, iq], kc[:, jk], vc[:, jk],
                                   q_pos, k_pos, Skv, causal, window, masked,
                                   use_reentrant=False)
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])  # (B,KH,G,cq,D)
    out = torch.stack(outs, dim=1)  # (B,nq,KH,G,cq,D)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * cq, H, D)
    return out[:, :Sq].to(q.dtype)


def attention_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """One-token attention over a cache on the decode-attention kernel.
    q:(B,H,D); caches:(B,S,KH,D); lengths:(B,) valid rows, at least 1.

    The kernel reads the caches in their storage type, sums in float32 and
    stops at each sequence's length."""
    if window > 0:
        raise NotImplementedError(_DECODE_WINDOW_TODO)
    if sharded(q):
        return attend_sharded(lambda a, b, c, n: decode_attention_op(a, b, c, n, scale=scale),
                              q, k_cache, v_cache, lengths, qd=1, mha=False)
    return decode_attention_op(q, k_cache, v_cache, lengths, scale=scale)


def decode_rows(lengths: torch.Tensor, S: int) -> torch.Tensor:
    """``lengths + 1``: the rows each sequence attends once a decode step
    has written its new K/V row at ``lengths`` of an S-row cache, checked
    to lie in [1, S] *before* the write. A full cache (a length of S)
    raises ValueError here; the reference's scatter drops the row silently
    (JAX's out-of-bounds ``.at[].set``), and an index past the cache would
    be an IndexError on the CPU and a device-side assert on the card. Under
    :func:`~repro_torch.kernels.attention.lengths_checked` (a captured
    step) the caller has checked its host copy and nothing is read. Of a
    DTensor each rank checks its own rows."""
    valid = lengths + 1
    check_lengths(valid.to_local() if sharded(valid) else valid, S,
                  f"a decode step over a cache of {S} rows: lengths + 1")
    return valid


# ---------------------------------------------------------------------------
# Attention block (projections + rope + attention)
# ---------------------------------------------------------------------------


def attn_proj_qkv(p: dict, x: torch.Tensor, cfg) -> tuple:
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq_col"]
    k = x @ p["wk_col"]
    v = x @ p["wv_col"]
    if cfg.qkv_bias:
        q = q + p["bq_col"]
        k = k + p["bk_col"]
        v = v + p["bv_col"]
    return split_heads(q, H, hd), split_heads(k, KH, hd), split_heads(v, KH, hd)


def attn_proj_kv(p: dict, x: torch.Tensor, cfg) -> tuple:
    """The K and V of :func:`attn_proj_qkv` without its query: a cross
    attention's cache, whose query comes from the decoder."""
    KH, hd = cfg.n_kv_heads, cfg.hd
    k = x @ p["wk_col"]
    v = x @ p["wv_col"]
    if cfg.qkv_bias:
        k = k + p["bk_col"]
        v = v + p["bv_col"]
    return split_heads(k, KH, hd), split_heads(v, KH, hd)


def expand_heads_for_tp(q, k, v, cfg):
    """Repeat-KV (GQA -> MHA view) + zero-pad heads to cfg.tp_pad_heads.

    Exact math: MHA head h uses repeated kv[h] == original kv[h // G], the
    same q->kv assignment GQA computes; zero-padded q heads produce outputs
    that the caller slices away before the output projection. A no-op when
    ``tp_pad_heads`` is 0, as for every config the port serves today."""
    Hp = getattr(cfg, "tp_pad_heads", 0)
    H, KH = q.shape[2], k.shape[2]
    if not Hp or Hp < H:
        return q, k, v, H
    if KH < H:
        G = H // KH
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    pad = Hp - H
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    return q, k, v, H


def attn_block(
    p: dict, x: torch.Tensor, cfg, *, positions, causal=True, window=0, train=False,
) -> torch.Tensor:
    """Full-sequence attention block: the prefill's on the flash-attention
    kernel, or with ``train`` the differentiable :func:`attention_train`.
    The reference's ``kv_override`` has no caller on these paths (whisper's
    prefill projects its cross K/V itself) and is not ported."""
    B, S, _ = x.shape
    q, k, v = attn_proj_qkv(p, grad_as_value(x), cfg)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q, k, v, H = expand_heads_for_tp(q, k, v, cfg)
    attend = attention_train if train else attention_chunked
    out = attend(q, k, v, causal=causal, window=window)
    out = grad_as_value(out[:, :, :H].reshape(B, S, cfg.n_heads * cfg.hd))
    return settle(out @ p["wo_row"])


def mlp_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    x = grad_as_value(x)
    if cfg.mlp_act == "silu_gated":
        g = x @ p["wg_col"]
        u = x @ p["wu_col"]
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    else:  # gelu (the reference's jax.nn.gelu is the tanh form)
        h = x @ p["wu_col"]
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return settle(h @ p["wd_row"])


# ---------------------------------------------------------------------------
# Embedding / logits / loss
# ---------------------------------------------------------------------------


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``embed`` at ``tokens``. ``F.embedding``'s backward sums
    the rows' gradients by sorting the tokens, without atomics."""
    return F.embedding(tokens, embed)


def lm_logits(x: torch.Tensor, out_embed: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D); out_embed: (D,V) column-parallel."""
    return x @ out_embed


def _xent_chunk(xb, lb, out_embed, vocab_size):
    """(sum of -log p(label), count of valid labels) over one chunk, as the
    reference's scan step computes them: logits rounded to the storage type
    by the product, then float32. On DTensors, a vocab split over ``model``
    takes :func:`_xent_chunk_sharded`; one that is not, this function on
    each rank's rows (its sums partial over the ranks holding other rows),
    which is then the plain path's arithmetic."""
    if sharded(xb):
        d = mesh_dim(out_embed.device_mesh, "model")
        if d is not None and out_embed.placements[d] == Shard(1) and \
                out_embed.device_mesh.size(d) > 1:
            return _xent_chunk_sharded(xb, lb, out_embed, vocab_size)
        return _xent_chunk_rows(xb, lb, out_embed, vocab_size)
    logits = (xb @ out_embed).float()
    Vp = out_embed.shape[1]
    if vocab_size is not None and vocab_size < Vp:
        pad = torch.arange(Vp, device=logits.device) >= vocab_size
        logits = torch.where(pad, NEG_INF, logits)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(lb, min=0)[..., None].long())[..., 0]
    valid = (lb >= 0).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def _xent_chunk_rows(xb, lb, out_embed, vocab_size):
    """:func:`_xent_chunk` on each rank's rows of ``xb`` and ``lb`` with
    the whole vocab: both sums partial over the mesh dims the rows are
    split on, and so is ``out_embed``'s gradient where it is replicated."""
    mesh = xb.device_mesh
    if not sharded(lb):  # the same on every rank
        lb = DTensor.from_local(lb, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lb = lb.redistribute(mesh, xb.placements)  # the same rows as xb's (batch, sequence)
    part = [Partial() if p.is_shard() else Replicate() for p in xb.placements]
    emb_grad = [Partial() if x.is_shard() and e == Replicate() else e
                for x, e in zip(xb.placements, out_embed.placements)]
    run = local_map(lambda x, lab, w: _xent_chunk(x, lab, w, vocab_size),
                    out_placements=(tuple(part), tuple(part)),
                    in_placements=(tuple(xb.placements), tuple(lb.placements),
                                   tuple(out_embed.placements)),
                    in_grad_placements=(tuple(xb.placements), tuple(lb.placements),
                                        tuple(emb_grad)),
                    redistribute_inputs=True, device_mesh=mesh)
    return run(xb, lb, out_embed)


def _vocab_ids(out_embed: DTensor) -> DTensor:
    """0 … Vp-1 laid out as ``out_embed``'s columns (its vocab sharded
    over ``model``): each rank makes its own slice."""
    mesh = out_embed.device_mesh
    d = mesh_dim(mesh, "model")
    Vp = out_embed.shape[1]
    Vl = Vp // mesh.size(d)
    lo = mesh.get_local_rank(d) * Vl
    pl = [Replicate()] * mesh.ndim
    pl[d] = Shard(0)
    return from_local(torch.arange(lo, lo + Vl, device=out_embed.device), mesh, pl, (Vp,))


class _VocabXent(torch.autograd.Function):
    """Σ over tokens of (log-sum-exp − the label's logit) · valid, over
    logits (B, c, Vp) sharded over ``model`` on the vocab: the max and the
    sums all-reduced, never the logits, and the analytic gradient
    (softmax − one-hot) · valid laid out as the logits. torch's
    ``logsumexp`` formula (the max, then the log of the sum of the
    exponentials, plus the max)."""

    @staticmethod
    def forward(ctx, logits, gold_mask, valid):
        m = with_placements(logits.amax(dim=-1, keepdim=True), model=Replicate())
        e = torch.exp(logits - m)
        s = with_placements(e.sum(dim=-1, keepdim=True), model=Replicate())
        lse = torch.log(s[..., 0]) + m[..., 0]
        gold = with_placements(torch.where(gold_mask, logits, 0.0).sum(dim=-1),
                               model=Replicate())
        ctx.save_for_backward(e / s, gold_mask, valid)
        return ((lse - gold) * valid).sum()

    @staticmethod
    def backward(ctx, g):
        p, gold_mask, valid = ctx.saved_tensors
        return (p - gold_mask.float()) * (valid * g)[..., None], None, None


def _xent_chunk_sharded(xb, lb, out_embed, vocab_size):
    """:func:`_xent_chunk` over vocab-sharded logits, without gathering
    them (:class:`_VocabXent`); the label's logit picked by a mask made on
    each rank's vocab slice."""
    logits = (grad_as_value(xb) @ out_embed).float()
    ids = _vocab_ids(out_embed)
    if vocab_size is not None and vocab_size < out_embed.shape[1]:
        logits = torch.where(ids >= vocab_size, NEG_INF, logits)
    valid = (lb >= 0).float()
    gold_mask = ids == torch.clamp(lb, min=0)[..., None].long()
    return _VocabXent.apply(logits, gold_mask, valid), valid.sum()


def pad_rows(t: torch.Tensor, pad: int, value: float = 0) -> torch.Tensor:
    """``t`` (B, S, ...) with ``pad`` rows of ``value`` after its S; a
    DTensor (its S not sharded) padded on each rank's shard, whose layout
    DTensor's own padding does not keep on every version."""
    widths = (0, 0) * (t.ndim - 2) + (0, pad)
    if not sharded(t):
        return F.pad(t, widths, value=value)
    pl = tuple(t.placements)
    return local_map(lambda a: F.pad(a, widths, value=value), out_placements=(pl,),
                     in_placements=(pl,), device_mesh=t.device_mesh)(t)


def xent_loss_chunked(x: torch.Tensor, out_embed: torch.Tensor, labels: torch.Tensor,
                      chunk: int = 512, vocab_size: int | None = None) -> torch.Tensor:
    """Sequence-chunked softmax cross-entropy, the mean over labels >= 0:
    each chunk of ``chunk`` positions runs under ``torch.utils.checkpoint``,
    so the live logits are (B, chunk, V) in float32 and the backward
    recomputes them. ``vocab_size`` masks the padded vocab columns with
    -1e30. A DTensor ``x`` is settled first (its sequence gathered over
    ``model`` under ``act_shard="seq"``): the chunks slice the sequence."""
    x = settle(x)
    B, S, D = x.shape
    pad = (-S) % chunk
    if pad:
        x = pad_rows(x, pad)
        labels = pad_rows(labels, pad, value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(x.shape[1] // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, c = checkpoint(_xent_chunk, x[:, sl], labels[:, sl], out_embed, vocab_size,
                          use_reentrant=False)
        tot = tot + t
        cnt = cnt + c
    return tot / torch.clamp(cnt, min=1.0)
