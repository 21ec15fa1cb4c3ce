"""Model zoo: the reference zoo's ten architectures on PyTorch, every
family of its registry: the decoder LMs (dense, moe, and vlm with its
patch projector), the enc-dec whisper (encdec) and the two recurrent
families (ssm: xlstm; hybrid: zamba2).

Every model exposes the reference's surface:

  shapes   — nested dict of param shapes (per-leaf dtype via cfg.dtype)
  init     — draw the parameters on the device from a seeded generator
  loss     — train-mode forward → scalar loss
  prefill  — full-prompt forward → (last logits, caches)
  decode   — one-token step over caches → (logits, caches)

Family notes:
  llava   decoder LM; vision patches arrive as precomputed embeddings
          (``batch["patches"]``, (B, 576, d_model)) and a learned
          projector prepends them to the token sequence, so RoPE positions
          and ``decode``'s ``lengths`` count the patch rows.
  whisper enc-dec; the conv frontend is a stub (``batch["frames"]``,
          precomputed (B, 1500, d_model) frame embeddings). The encoder adds
          sinusoidal positions and also applies RoPE; the decoder uses RoPE.
          Prefill returns (self K, self V, cross K, cross V) caches; its
          and decode's cross-attention query has no bias and no RoPE, as in
          the reference.
  xlstm   grouped stacks: (slstm_every-1) mLSTM + 1 sLSTM per group.
  zamba2  Mamba2 stack with ONE shared attention+MLP block applied after
          every ``attn_every`` SSM layers (weight sharing), sliding-window
          attention in the prefill and a ring-buffer KV cache of
          min(S, window) rows in decode.
As in the reference, the two recurrent prefills run the full forward and
return the last logits with *zeroed* state and caches ("dry-run
sufficient"), so a decode after a prefill starts from zero state. Decode
writes the new state and K/V rows into the caches it is given, in place,
and returns them (the reference returns new arrays); a decode step that
would write past a full K/V cache raises ValueError before the write,
where the reference drops the row silently.

``loss`` is the reference's ``_lm_loss`` for the decoder LMs (the vlm's
over the text rows after the projected patches), ``_whisper_loss`` for
the enc-dec (its cross query with ``bq_col``, which the prefill's lacks),
``_xlstm_loss`` and ``_zamba_loss`` for the recurrent families, on the
differentiable ``attention_train``, never on a kernel; the train step in
``repro_torch.train`` takes its gradients. Under ``cfg.remat`` each
decoder, encoder, Mamba2 and mLSTM layer of the loss's forward runs under
``torch.utils.checkpoint`` (an sLSTM layer's steps are checkpointed one
by one).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.base import ArchConfig, ShapeSpec, struct
from repro_torch.models.transformer import (
    attn_param_shapes,
    decoder_decode_step,
    decoder_forward,
    decoder_layer_shapes,
    decoder_prefill,
    embed_lookup,
    encdec_decoder_forward,
    encoder_forward,
    layer_params,
    mlp_param_shapes,
    n_stacked,
    stack_shapes,
)

_ONES = ("ln1", "ln2", "ln", "ln_x", "final_norm", "d_skip")  # initialised to ones
_F32_ZEROS = ("dt_bias", "a_log")  # zeros in float32, whatever the dtype (A = -1)
_STACKS = ("layers", "encoder_layers", "mlayers", "slayers")  # stacked per-layer trees


def _enc_frames(cfg: ArchConfig) -> int:  # whisper audio frames (30 s): stub frontend length
    return cfg.frontend_tokens or 1500


def _vlm_patches(cfg: ArchConfig) -> int:  # llava patch embeddings an image: stub frontend
    return cfg.frontend_tokens or 576


def _frontend_input(batch: dict, key: str, rows: int, cfg: ArchConfig,
                    what: str = "prefill") -> torch.Tensor:
    """The stub frontend's embeddings, ``batch[key]``; a batch without them
    raises the reference's KeyError, saying what the prefill (or ``what``)
    takes."""
    if key not in batch:
        raise KeyError(f"{key}: the {cfg.family} {what} takes precomputed (B, {rows}, "
                       f"{cfg.d_model}) {key} beside the tokens")
    return batch[key]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _vp(cfg: ArchConfig) -> int:
    """Vocab padded to a mesh-divisible multiple (MaxText-style)."""
    return ((cfg.vocab_size + 255) // 256) * 256


def _head(h, params, cfg):
    """LM head with padded-vocab masking. h: (..., D) -> (..., Vp)."""
    z = h @ params["out_embed"]
    V, Vp = cfg.vocab_size, params["out_embed"].shape[1]
    if Vp > V and L.sharded(z):  # the vocab sharded over model: no write in place
        pad = torch.arange(Vp, device=z.device) >= V
        return torch.where(pad, torch.tensor(-1e30, dtype=z.dtype, device=z.device), z)
    if Vp > V:
        z[..., V:] = -1e30
    return z


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


SHARDED_FAMILIES = ("dense", "vlm")  # the families that run on sharded parameters
SHARDED_TODO = {
    "moe": "routing under DTensor (ROADMAP Queue 1 item 10, the dry run of moe)",
    "ssm": "the SSD and sLSTM scans under DTensor (ROADMAP Queue 1 item 10, the dry run "
           "of ssm and hybrid)",
    "hybrid": "the SSD scan and the shared block under DTensor (ROADMAP Queue 1 item 10, "
              "the dry run of ssm and hybrid)",
    "encdec": "the encoder under DTensor (ROADMAP Queue 1 item 10, the dry run of encdec)",
}


def params_sharded(params: dict) -> bool:
    """Whether ``params`` are DTensors (placed by ``shardings_for``)."""
    return any(L.sharded(v) for _, v in _leaves(params))


def sharded_call(cfg: ArchConfig, params: dict, mesh=None):
    """The context a call on ``params`` runs in: none for plain tensors;
    for DTensors :func:`~repro_torch.models.layers.replicate_plain` (a
    plain tensor among them, such as the positions, is the same on every
    rank and stands replicated), after refusing a ``mesh=`` (the parameters
    carry theirs: a call runs one path, never both) and a family not yet
    ported to sharded parameters. A backward through a sharded loss runs
    in such a context too (``train.step.make_train_step``)."""
    if not params_sharded(params):
        return contextlib.nullcontext()
    if mesh is not None:
        raise ValueError("sharded parameters carry their mesh: call without mesh=")
    if cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(f"{cfg.family} on sharded parameters: "
                                  f"{SHARDED_TODO[cfg.family]}")
    return L.replicate_plain()


class Model(nn.Module):
    """An LM of a built family. Its parameters are a nested dict of tensors
    in the reference's layout (stacked per-layer leaves under ``layers``,
    whisper's ``encoder_layers``, or xlstm's ``mlayers`` and ``slayers``);
    after :meth:`init` the module
    holds them, one frozen ``nn.Parameter`` a leaf keyed by its path
    (``layers/attn/wq_col``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.cfg = cfg
        self._shapes, self._loss, self._prefill, self._decode = _FAMILIES[cfg.family]
        self._input_specs = _INPUT_SPECS[cfg.family]
        self.shapes = self._shapes(cfg)
        self.leaves = nn.ParameterDict()

    def init(self, generator: torch.Generator, device=None, dtype=None) -> dict:
        """Draw every leaf on ``device`` (the card unless asked otherwise)
        from ``generator``, which must live there: norms and ``d_skip`` are
        ones, ``dt_bias`` and ``a_log`` zeros in float32 whatever the dtype,
        the rest normal with the reference's scale, 0.02 or 1/sqrt(fan_in)
        if that is smaller, cast to ``dtype`` (the config's by default).
        Stacked leaves are drawn a layer at a time, so no float32 copy of a
        whole leaf is made. Returns the nested parameter dict."""
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(
                f"init draws on {dev}: pass a torch.Generator made there, "
                f"not on {generator.device}"
            )
        dt = dtype or _dtype(self.cfg)
        for path, shape in _leaves(self.shapes):
            name = path.split("/")[-1]
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 0.02 if len(shape) < 2 else min(0.02, (1.0 / fan_in) ** 0.5)
            if name in _ONES:
                leaf = torch.ones(shape, dtype=dt, device=dev)
            elif name in _F32_ZEROS:
                leaf = torch.zeros(shape, dtype=torch.float32, device=dev)
            else:
                leaf = torch.empty(shape, dtype=dt, device=dev)
                parts = leaf if path.split("/")[0] in _STACKS else leaf[None]
                for part in parts:
                    draw = torch.randn(part.shape, generator=generator,
                                       dtype=torch.float32, device=dev)
                    part.copy_(draw * scale)
            self.leaves[path] = nn.Parameter(leaf, requires_grad=False)
        return self.params()

    def params(self) -> dict:
        """The held leaves as the nested parameter dict (no copies)."""
        return _nest({k: v.data for k, v in self.leaves.items()})

    def loss(self, params: dict, batch: dict, mesh=None) -> torch.Tensor:
        """The train-mode forward's mean cross-entropy over ``batch``'s
        labels (those below 0 ignored): a float32 scalar. Differentiable in
        the leaves of ``params`` that require grad, without a mesh. On a
        mesh with a ``model`` axis the token embedding is the
        vocab-sharded lookup (:func:`embed_lookup`), as in ``prefill`` and
        ``decode``.

        Parameters placed by ``shardings_for`` (DTensors; the dense and
        vlm families) run sharded on their own mesh, differentiable, and
        take no ``mesh``: the batch and caches are DTensors or plain
        tensors alike on every rank, and the results DTensors
        (:func:`sharded_call`)."""
        with sharded_call(self.cfg, params, mesh):
            return self._loss(params, batch, self.cfg, mesh=mesh)

    def prefill(self, params: dict, batch: dict, cache_len: int | None = None, *, mesh=None):
        with sharded_call(self.cfg, params, mesh):
            return self._prefill(params, batch, self.cfg, cache_len=cache_len, mesh=mesh)

    def decode(self, params: dict, batch: dict, caches: tuple, mesh=None):
        with sharded_call(self.cfg, params, mesh):
            return self._decode(params, batch, caches, self.cfg, mesh=mesh)

    def input_specs(self, sp: ShapeSpec) -> dict:
        """The step's inputs for shape ``sp`` as tensors without storage
        (:func:`~repro_torch.models.base.struct`), with the reference's names,
        shapes, dtypes and order: a decode step's caches follow its tokens
        and lengths."""
        return self._input_specs(self.cfg, sp)


# ---------------------------------------------------------------------------
# Decoder-LM families (dense, moe, vlm)
# ---------------------------------------------------------------------------


def _lm_shapes(cfg: ArchConfig) -> dict:
    shapes = {
        "embed": (_vp(cfg), cfg.d_model),
        "out_embed": (cfg.d_model, _vp(cfg)),
        "final_norm": (cfg.d_model,),
        "layers": stack_shapes(decoder_layer_shapes(cfg), cfg.n_layers),
    }
    if cfg.frontend == "vision":
        shapes["vision_proj_col"] = (cfg.d_model, cfg.d_model)
    return shapes


def _lm_embed_inputs(params, batch, cfg, mesh=None):
    """The tokens' embeddings; for the vlm, after the projected patches
    (``batch["patches"]``, (B, P, d_model), cast to the model's dtype)."""
    tok_emb = embed_lookup(params["embed"], batch["tokens"], mesh).to(_dtype(cfg))
    if cfg.frontend == "vision":
        patches = _frontend_input(batch, "patches", _vlm_patches(cfg), cfg).to(_dtype(cfg))
        return torch.cat([L.settle(patches @ params["vision_proj_col"]), tok_emb], dim=1)
    return tok_emb


def _lm_loss(params, batch, cfg: ArchConfig, mesh=None):
    h = _lm_embed_inputs(params, batch, cfg, mesh)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    h = decoder_forward(params["layers"], h, cfg, positions=positions,
                        window=cfg.sliding_window)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    if cfg.frontend == "vision":  # the loss over the text positions only
        h = L.settle(h)[:, _vlm_patches(cfg):]
    return L.xent_loss_chunked(h, params["out_embed"], batch["labels"],
                               vocab_size=cfg.vocab_size)


def _lm_prefill(params, batch, cfg: ArchConfig, cache_len=None, mesh=None):
    h = _lm_embed_inputs(params, batch, cfg, mesh)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    h, caches = decoder_prefill(
        params["layers"], h, cfg, positions=positions, cache_len=cache_len or S,
        window=cfg.sliding_window,
    )
    h = L.rmsnorm(h[:, -1], params["final_norm"], cfg.norm_eps)
    return _head(h, params, cfg), caches


def _lm_decode(params, batch, caches, cfg: ArchConfig, mesh=None):
    tokens, lengths = batch["tokens"], batch["lengths"]
    h = embed_lookup(params["embed"], tokens[:, None], mesh)[:, 0].to(_dtype(cfg))
    h, caches = decoder_decode_step(
        params["layers"], h, caches, lengths, cfg, window=cfg.sliding_window
    )
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _head(h, params, cfg), caches



def _lm_input_specs(cfg: ArchConfig, sp: ShapeSpec) -> dict:
    B, Ss = sp.global_batch, sp.seq_len
    dt = _dtype(cfg)
    KH, hd, Ld = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    text = Ss - (_vlm_patches(cfg) if cfg.frontend == "vision" else 0)
    out: dict = {}
    if sp.kind == "train":
        out["tokens"] = struct((B, text), torch.int32)
        out["labels"] = struct((B, text), torch.int32)
        if cfg.frontend == "vision":
            out["patches"] = struct((B, _vlm_patches(cfg), cfg.d_model), dt)
    elif sp.kind == "prefill":
        out["tokens"] = struct((B, text), torch.int32)
        if cfg.frontend == "vision":
            out["patches"] = struct((B, _vlm_patches(cfg), cfg.d_model), dt)
    else:  # decode
        Sc = sp.seq_len if cfg.sliding_window == 0 else min(sp.seq_len, cfg.sliding_window)
        out["tokens"] = struct((B,), torch.int32)
        out["lengths"] = struct((B,), torch.int32)
        out["k_cache"] = struct((Ld, B, Sc, KH, hd), dt)
        out["v_cache"] = struct((Ld, B, Sc, KH, hd), dt)
    return out



# ---------------------------------------------------------------------------
# Whisper (encdec)
# ---------------------------------------------------------------------------


def _whisper_shapes(cfg: ArchConfig) -> dict:
    enc_layer = {
        "ln1": (cfg.d_model,),
        "ln2": (cfg.d_model,),
        "attn": attn_param_shapes(cfg),
        "mlp": mlp_param_shapes(cfg),
    }
    return {
        "embed": (_vp(cfg), cfg.d_model),
        "out_embed": (cfg.d_model, _vp(cfg)),
        "final_norm": (cfg.d_model,),
        "enc_final_norm": (cfg.d_model,),
        "encoder_layers": stack_shapes(enc_layer, cfg.encoder_layers),
        "layers": stack_shapes(decoder_layer_shapes(cfg, cross=True), cfg.n_layers),
    }


def _sinusoid(S: int, D: int) -> np.ndarray:
    """Sinusoidal positions (S, D) float32, computed in numpy in the
    reference's order of operations (so its bits are the reference's)."""
    pos = np.arange(S)[:, None]
    i = np.arange(D // 2)[None, :]
    ang = pos / (10000 ** (2 * i / D))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def _whisper_encode(params, frames, cfg: ArchConfig, train: bool = False):
    """frames (B, Se, d_model) plus the sinusoid, in the model's dtype;
    the encoder stack (the loss's with ``train``); its final norm."""
    B, Se, D = frames.shape
    dt = _dtype(cfg)
    sin = torch.from_numpy(_sinusoid(Se, D)).to(device=frames.device, dtype=dt)
    h = frames.to(dt) + sin[None]
    positions = torch.arange(Se, device=frames.device)[None, :].expand(B, Se)
    h = encoder_forward(params["encoder_layers"], h, cfg, positions, train=train)
    return L.rmsnorm(h, params["enc_final_norm"], cfg.norm_eps)


def _whisper_loss(params, batch, cfg: ArchConfig, mesh=None):
    """The reference's: the frames encoded on the training path, the
    tokens' embeddings through :func:`encdec_decoder_forward` (whose cross
    query adds ``bq_col``), the final norm, the chunked loss."""
    frames = _frontend_input(batch, "frames", _enc_frames(cfg), cfg, what="loss")
    enc = _whisper_encode(params, frames, cfg, train=True)
    tok = embed_lookup(params["embed"], batch["tokens"], mesh).to(_dtype(cfg))
    B, S, _ = tok.shape
    Se = enc.shape[1]
    positions = torch.arange(S, device=tok.device)[None, :].expand(B, S)
    enc_positions = torch.arange(Se, device=tok.device)[None, :].expand(B, Se)
    h = encdec_decoder_forward(params["layers"], tok, enc, cfg, positions=positions,
                               enc_positions=enc_positions)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.xent_loss_chunked(h, params["out_embed"], batch["labels"],
                               vocab_size=cfg.vocab_size)


def _cross_query(lp, hn, cfg: ArchConfig):
    """The cross-attention query: ``hn @ xattn.wq_col``, with no bias and no
    RoPE, as the reference's prefill and decode compute it (its training
    forward adds the bias: ``transformer._train_cross_query``)."""
    q = hn @ lp["xattn"]["wq_col"]
    return q.reshape(*hn.shape[:-1], cfg.n_heads, cfg.hd)


def _whisper_prefill(params, batch, cfg: ArchConfig, cache_len=None, mesh=None):
    """Encode the frames, project each decoder layer's cross K/V from the
    encoder's output (biases, no RoPE), then run the decoder over the
    prompt: causal self-attention with RoPE, cross-attention over the
    encoder rows, the MLP. Returns the last logits and (self K, self V,
    cross K, cross V): (L, B, cache_len, KH, hd) self caches, zero past the
    prompt, and (L, B, Se, KH, hd) cross caches."""
    enc = _whisper_encode(params, _frontend_input(batch, "frames", _enc_frames(cfg), cfg), cfg)
    layers = params["layers"]
    n_layers = n_stacked(layers)
    B, Se, _ = enc.shape
    h = embed_lookup(params["embed"], batch["tokens"], mesh).to(_dtype(cfg))
    S = h.shape[1]
    cache_len = cache_len or S
    KH, hd = cfg.n_kv_heads, cfg.hd
    kcs = torch.zeros((n_layers, B, cache_len, KH, hd), dtype=h.dtype, device=h.device)
    vcs = torch.zeros_like(kcs)
    xk = torch.empty((n_layers, B, Se, KH, hd), dtype=h.dtype, device=h.device)
    xv = torch.empty_like(xk)
    positions = torch.arange(S, device=h.device)[None, :].expand(B, S)
    for i in range(n_layers):
        lp = layer_params(layers, i)
        xk[i], xv[i] = L.attn_proj_kv(lp["xattn"], enc, cfg)
        hn = L.rmsnorm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = L.attn_proj_qkv(lp["attn"], hn, cfg)
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
        att = L.attention_chunked(q, k, v, causal=True)
        h = h + att.reshape(B, S, -1) @ lp["attn"]["wo_row"]
        qx = _cross_query(lp, L.rmsnorm(h, lp["ln_x"], cfg.norm_eps), cfg)
        attx = L.attention_chunked(qx, xk[i], xv[i], causal=False)
        h = h + attx.reshape(B, S, -1) @ lp["xattn"]["wo_row"]
        h = h + L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["ln2"], cfg.norm_eps), cfg)
        kcs[i, :, :S] = k
        vcs[i, :, :S] = v
    h = L.rmsnorm(h[:, -1], params["final_norm"], cfg.norm_eps)
    return _head(h, params, cfg), (kcs, vcs, xk, xv)


def _whisper_decode(params, batch, caches, cfg: ArchConfig, mesh=None):
    """One token for every sequence: its self K/V row written at
    ``lengths`` (in place), self-attention over lengths + 1 rows,
    cross-attention over every encoder row. A full self cache raises
    (:func:`~repro_torch.models.layers.decode_rows`)."""
    kcs, vcs, xk, xv = caches
    tokens, lengths = batch["tokens"], batch["lengths"]
    B = tokens.shape[0]
    h = embed_lookup(params["embed"], tokens[:, None], mesh)[:, 0].to(_dtype(cfg))
    valid = L.decode_rows(lengths, kcs.shape[2])
    enc_len = torch.full((B,), xk.shape[2], dtype=torch.int32, device=h.device)
    rows = torch.arange(B, device=h.device)
    for i in range(n_stacked(params["layers"])):
        lp = layer_params(params["layers"], i)
        hn = L.rmsnorm(h, lp["ln1"], cfg.norm_eps)[:, None]
        q, k, v = L.attn_proj_qkv(lp["attn"], hn, cfg)
        q = L.rope(q, lengths[:, None], cfg.rope_theta)
        k = L.rope(k, lengths[:, None], cfg.rope_theta)
        kcs[i][rows, lengths] = k[:, 0]
        vcs[i][rows, lengths] = v[:, 0]
        att = L.attention_decode(q[:, 0], kcs[i], vcs[i], valid)
        h = h + att.reshape(B, -1) @ lp["attn"]["wo_row"]
        qx = _cross_query(lp, L.rmsnorm(h, lp["ln_x"], cfg.norm_eps), cfg)
        attx = L.attention_decode(qx, xk[i], xv[i], enc_len)
        h = h + attx.reshape(B, -1) @ lp["xattn"]["wo_row"]
        h = h + L.mlp_block(lp["mlp"], L.rmsnorm(h, lp["ln2"], cfg.norm_eps)[:, None],
                            cfg)[:, 0]
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _head(h, params, cfg), caches


def _whisper_input_specs(cfg: ArchConfig, sp: ShapeSpec) -> dict:
    B, Ss = sp.global_batch, sp.seq_len
    dt = _dtype(cfg)
    KH, hd, Ld = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    out: dict = {}
    if sp.kind == "train":
        out["frames"] = struct((B, _enc_frames(cfg), cfg.d_model), dt)
        out["tokens"] = struct((B, Ss), torch.int32)
        out["labels"] = struct((B, Ss), torch.int32)
    elif sp.kind == "prefill":
        out["frames"] = struct((B, _enc_frames(cfg), cfg.d_model), dt)
        out["tokens"] = struct((B, Ss), torch.int32)
    else:
        out["tokens"] = struct((B,), torch.int32)
        out["lengths"] = struct((B,), torch.int32)
        out["k_cache"] = struct((Ld, B, Ss, KH, hd), dt)
        out["v_cache"] = struct((Ld, B, Ss, KH, hd), dt)
        out["xk_cache"] = struct((Ld, B, _enc_frames(cfg), KH, hd), dt)
        out["xv_cache"] = struct((Ld, B, _enc_frames(cfg), KH, hd), dt)
    return out



# ---------------------------------------------------------------------------
# xLSTM (ssm family)
# ---------------------------------------------------------------------------


def _xlstm_layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_groups, mlstm_per_group, n_slstm)."""
    k = cfg.slstm_every
    n_groups = cfg.n_layers // k
    return n_groups, k - 1, n_groups


def _xlstm_shapes(cfg: ArchConfig) -> dict:
    ng, mpg, ns = _xlstm_layout(cfg)
    m_layer = {"ln": (cfg.d_model,), **S.mlstm_param_shapes(cfg)}
    s_layer = {"ln": (cfg.d_model,), **S.slstm_param_shapes(cfg)}
    return {
        "embed": (_vp(cfg), cfg.d_model),
        "out_embed": (cfg.d_model, _vp(cfg)),
        "final_norm": (cfg.d_model,),
        "mlayers": stack_shapes(m_layer, ng * mpg),
        "slayers": stack_shapes(s_layer, ns),
    }


def _residual(layer, lp: dict, h, cfg: ArchConfig):
    """``h + layer(lp, rmsnorm(h))``: one residual Mamba2, mLSTM or sLSTM
    layer."""
    return h + layer(lp, L.rmsnorm(h, lp["ln"], cfg.norm_eps), cfg)


def _ssm_block(layer, lp: dict, h, cfg: ArchConfig, remat: bool):
    """:func:`_residual`, with ``remat`` inside ``torch.utils.checkpoint``,
    so the backward keeps the layer's input alone (the reference's
    ``jax.checkpoint`` on its scan bodies)."""
    if remat:
        return checkpoint(_residual, layer, lp, h, cfg, use_reentrant=False)
    return _residual(layer, lp, h, cfg)


def _xlstm_forward(params, h, cfg: ArchConfig, train: bool = False):
    """The layer stack: the prefill's (``train`` False) and the loss's,
    whose mLSTM layers run under a checkpoint with ``cfg.remat``. Its
    sLSTM layers do not, as in the reference, whose loop calls
    ``slstm_layer`` itself and leaves its checkpointed ``s_body`` unused:
    each sLSTM step is checkpointed already, and recomputing the layer
    would run its sequential loop once more."""
    ng, mpg, _ = _xlstm_layout(cfg)
    remat = train and cfg.remat
    for g in range(ng):
        for j in range(mpg):
            h = _ssm_block(S.mlstm_layer, layer_params(params["mlayers"], g * mpg + j), h,
                           cfg, remat)
        h = _residual(S.slstm_layer, layer_params(params["slayers"], g), h, cfg)
    return h


def _xlstm_loss(params, batch, cfg: ArchConfig, mesh=None):
    h = embed_lookup(params["embed"], batch["tokens"], mesh).to(_dtype(cfg))
    h = _xlstm_forward(params, h, cfg, train=True)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.xent_loss_chunked(h, params["out_embed"], batch["labels"],
                               vocab_size=cfg.vocab_size)


def _xlstm_prefill(params, batch, cfg: ArchConfig, cache_len=None, mesh=None):
    """The full forward and the last logits, with zeroed state (the
    reference's dry-run-sufficient prefill)."""
    h = embed_lookup(params["embed"], batch["tokens"], mesh).to(_dtype(cfg))
    h = _xlstm_forward(params, h, cfg)
    hl = L.rmsnorm(h[:, -1], params["final_norm"], cfg.norm_eps)
    return _head(hl, params, cfg), _xlstm_zero_state(cfg, h.shape[0], _dtype(cfg), h.device)


def _xlstm_zero_state(cfg: ArchConfig, B: int, dt, device):
    """(mh, mn, sc, sn, sm, sy): the mLSTM memories and normalisers, the
    sLSTM cells, normalisers, stabilisers (-30) and last outputs."""
    ng, mpg, ns = _xlstm_layout(cfg)
    H = cfg.n_heads
    P = cfg.d_model // H
    nm = ng * mpg
    f32 = dict(dtype=torch.float32, device=device)
    return (
        torch.zeros((nm, B * H, 1, P, P), **f32),
        torch.zeros((nm, B * H, 1, P, 1), **f32),
        torch.zeros((ns, B, cfg.d_model), **f32),
        torch.zeros((ns, B, cfg.d_model), **f32),
        torch.full((ns, B, cfg.d_model), -30.0, **f32),
        torch.zeros((ns, B, H, P), dtype=dt, device=device),
    )


def _xlstm_decode(params, batch, caches, cfg: ArchConfig, mesh=None):
    ng, mpg, _ = _xlstm_layout(cfg)
    mh, mn, sc, sn, sm, sy = caches
    h = embed_lookup(params["embed"], batch["tokens"][:, None], mesh)[:, 0].to(_dtype(cfg))
    for g in range(ng):
        for j in range(mpg):
            i = g * mpg + j
            lp = layer_params(params["mlayers"], i)
            y, (h2, n2) = S.mlstm_decode(lp, L.rmsnorm(h, lp["ln"], cfg.norm_eps),
                                         (mh[i], mn[i]), cfg)
            h = h + y
            mh[i].copy_(h2)
            mn[i].copy_(n2)
        sl = layer_params(params["slayers"], g)
        y, st = S.slstm_decode(sl, L.rmsnorm(h, sl["ln"], cfg.norm_eps),
                               (sc[g], sn[g], sm[g], sy[g]), cfg)
        h = h + y
        for cache, new in zip((sc, sn, sm, sy), st):
            cache[g].copy_(new)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _head(h, params, cfg), caches


def _xlstm_input_specs(cfg: ArchConfig, sp: ShapeSpec) -> dict:
    B, Ss = sp.global_batch, sp.seq_len
    dt = _dtype(cfg)
    ng, mpg, ns = _xlstm_layout(cfg)
    H = cfg.n_heads
    P = cfg.d_model // H
    nm = ng * mpg
    f32, i32 = torch.float32, torch.int32
    if sp.kind == "train":
        return {"tokens": struct((B, Ss), i32), "labels": struct((B, Ss), i32)}
    if sp.kind == "prefill":
        return {"tokens": struct((B, Ss), i32)}
    return {
        "tokens": struct((B,), i32),
        "lengths": struct((B,), i32),
        "mh": struct((nm, B * H, 1, P, P), f32),
        "mn": struct((nm, B * H, 1, P, 1), f32),
        "sc": struct((ns, B, cfg.d_model), f32),
        "sn": struct((ns, B, cfg.d_model), f32),
        "sm": struct((ns, B, cfg.d_model), f32),
        "sy": struct((ns, B, H, P), dt),
    }



# ---------------------------------------------------------------------------
# Zamba2 (hybrid: Mamba2 stack + ONE shared attention/MLP block)
# ---------------------------------------------------------------------------


def _zamba_layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_groups, ssm_per_group, remainder)."""
    k = cfg.attn_every
    ng = cfg.n_layers // k
    return ng, k, cfg.n_layers - ng * k


def _zamba_shapes(cfg: ArchConfig) -> dict:
    m_layer = {"ln": (cfg.d_model,), **S.mamba2_param_shapes(cfg)}
    shared = {
        "ln1": (cfg.d_model,),
        "ln2": (cfg.d_model,),
        "attn": attn_param_shapes(cfg),
        "mlp": mlp_param_shapes(cfg),
    }
    return {
        "embed": (_vp(cfg), cfg.d_model),
        "out_embed": (cfg.d_model, _vp(cfg)),
        "final_norm": (cfg.d_model,),
        "layers": stack_shapes(m_layer, cfg.n_layers),
        "shared": shared,
    }


def _zamba_forward(params, h, cfg: ArchConfig, positions, train: bool = False):
    """The layer stack: the prefill's (``train`` False: the shared block on
    the flash-attention kernel) and the loss's (on ``attention_train``; as
    in the reference, only the Mamba2 layers are checkpointed)."""
    ng, k, rem = _zamba_layout(cfg)
    sh = params["shared"]

    def mamba(h, i):
        return _ssm_block(S.mamba2_layer, layer_params(params["layers"], i), h, cfg,
                          train and cfg.remat)

    for g in range(ng):
        for j in range(k):
            h = mamba(h, g * k + j)
        h = h + L.attn_block(
            sh["attn"], L.rmsnorm(h, sh["ln1"], cfg.norm_eps), cfg,
            positions=positions, causal=True, window=cfg.sliding_window, train=train,
        )
        h = h + L.mlp_block(sh["mlp"], L.rmsnorm(h, sh["ln2"], cfg.norm_eps), cfg)
    for i in range(ng * k, ng * k + rem):
        h = mamba(h, i)
    return h


def _zamba_loss(params, batch, cfg: ArchConfig, mesh=None):
    h = embed_lookup(params["embed"], batch["tokens"], mesh).to(_dtype(cfg))
    B, Ss, _ = h.shape
    positions = torch.arange(Ss, device=h.device)[None, :].expand(B, Ss)
    h = _zamba_forward(params, h, cfg, positions, train=True)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return L.xent_loss_chunked(h, params["out_embed"], batch["labels"],
                               vocab_size=cfg.vocab_size)


def _zamba_prefill(params, batch, cfg: ArchConfig, cache_len=None, mesh=None):
    """The full forward and the last logits, with zeroed state and caches
    of min(S, window) rows (the reference's dry-run-sufficient prefill)."""
    h = embed_lookup(params["embed"], batch["tokens"], mesh).to(_dtype(cfg))
    B, Ss, _ = h.shape
    positions = torch.arange(Ss, device=h.device)[None, :].expand(B, Ss)
    h = _zamba_forward(params, h, cfg, positions)
    hl = L.rmsnorm(h[:, -1], params["final_norm"], cfg.norm_eps)
    return _head(hl, params, cfg), _zamba_zero_state(cfg, B, Ss, _dtype(cfg), h.device)


def _zamba_zero_state(cfg: ArchConfig, B: int, S_cache: int, dt, device):
    """(ssm_h, conv_buf, k_cache, v_cache): the Mamba2 states (f32) and conv
    buffers of every layer, and the shared block's ring-buffer K/V of
    Sw = min(S_cache, window) rows for each of its applications."""
    ng, k, rem = _zamba_layout(cfg)
    H, N = cfg.ssm_heads, cfg.ssm_state
    P = cfg.d_inner // H
    Ck = cfg.d_inner + 2 * N
    Sw = min(S_cache, cfg.sliding_window) if cfg.sliding_window else S_cache
    kv = (ng, B, Sw, cfg.n_kv_heads, cfg.hd)
    return (
        torch.zeros((cfg.n_layers, B, H, N, P), dtype=torch.float32, device=device),
        torch.zeros((cfg.n_layers, B, cfg.ssm_conv - 1, Ck), dtype=dt, device=device),
        torch.zeros(kv, dtype=dt, device=device),
        torch.zeros(kv, dtype=dt, device=device),
    )


def _zamba_decode(params, batch, caches, cfg: ArchConfig, mesh=None):
    """One token for every sequence. The shared block writes its K/V row at
    ``lengths mod Sw`` of its ring buffer and attends min(lengths + 1, Sw)
    rows (the reference's decode passes no window: the ring is the
    window)."""
    ssm_h, conv_buf, kcs, vcs = caches
    tokens, lengths = batch["tokens"], batch["lengths"]
    B = tokens.shape[0]
    Sw = kcs.shape[2]
    h = embed_lookup(params["embed"], tokens[:, None], mesh)[:, 0].to(_dtype(cfg))
    ng, k, rem = _zamba_layout(cfg)
    sh = params["shared"]
    slot = torch.remainder(lengths, Sw)  # the ring buffer's row for this token
    valid = torch.clamp(lengths + 1, max=Sw)
    rows = torch.arange(B, device=h.device)

    def mamba(h, i):
        lp = layer_params(params["layers"], i)
        y, (h2, c2) = S.mamba2_decode(lp, L.rmsnorm(h, lp["ln"], cfg.norm_eps),
                                      (ssm_h[i], conv_buf[i]), cfg)
        ssm_h[i].copy_(h2)
        conv_buf[i].copy_(c2)
        return h + y

    for g in range(ng):
        for j in range(k):
            h = mamba(h, g * k + j)
        hn = L.rmsnorm(h, sh["ln1"], cfg.norm_eps)[:, None]
        q, kk, vv = L.attn_proj_qkv(sh["attn"], hn, cfg)
        q = L.rope(q, lengths[:, None], cfg.rope_theta)
        kk = L.rope(kk, lengths[:, None], cfg.rope_theta)
        kc, vc = kcs[g], vcs[g]
        kc[rows, slot] = kk[:, 0]
        vc[rows, slot] = vv[:, 0]
        att = L.attention_decode(q[:, 0], kc, vc, valid)
        h = h + att.reshape(B, -1) @ sh["attn"]["wo_row"]
        h = h + L.mlp_block(sh["mlp"], L.rmsnorm(h, sh["ln2"], cfg.norm_eps)[:, None],
                            cfg)[:, 0]
    for i in range(ng * k, ng * k + rem):
        h = mamba(h, i)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    return _head(h, params, cfg), caches


def _zamba_input_specs(cfg: ArchConfig, sp: ShapeSpec) -> dict:
    B, Ss = sp.global_batch, sp.seq_len
    dt = _dtype(cfg)
    ng, k, rem = _zamba_layout(cfg)
    H, N = cfg.ssm_heads, cfg.ssm_state
    P = cfg.d_inner // H
    Ck = cfg.d_inner + 2 * N
    i32 = torch.int32
    if sp.kind == "train":
        return {"tokens": struct((B, Ss), i32), "labels": struct((B, Ss), i32)}
    if sp.kind == "prefill":
        return {"tokens": struct((B, Ss), i32)}
    Sw = min(Ss, cfg.sliding_window) if cfg.sliding_window else Ss
    return {
        "tokens": struct((B,), i32),
        "lengths": struct((B,), i32),
        "ssm_h": struct((cfg.n_layers, B, H, N, P), torch.float32),
        "conv_buf": struct((cfg.n_layers, B, cfg.ssm_conv - 1, Ck), dt),
        "k_cache": struct((ng, B, Sw, cfg.n_kv_heads, cfg.hd), dt),
        "v_cache": struct((ng, B, Sw, cfg.n_kv_heads, cfg.hd), dt),
    }



# ---------------------------------------------------------------------------
# build_model dispatch
# ---------------------------------------------------------------------------

# family -> (shapes, loss, prefill, decode)
_FAMILIES = {
    "dense": (_lm_shapes, _lm_loss, _lm_prefill, _lm_decode),
    "moe": (_lm_shapes, _lm_loss, _lm_prefill, _lm_decode),
    "vlm": (_lm_shapes, _lm_loss, _lm_prefill, _lm_decode),
    "encdec": (_whisper_shapes, _whisper_loss, _whisper_prefill, _whisper_decode),
    "ssm": (_xlstm_shapes, _xlstm_loss, _xlstm_prefill, _xlstm_decode),
    "hybrid": (_zamba_shapes, _zamba_loss, _zamba_prefill, _zamba_decode),
}

# family -> its input specs (the reference's ``Model.input_specs``)
_INPUT_SPECS = {"dense": _lm_input_specs, "moe": _lm_input_specs, "vlm": _lm_input_specs,
                "encdec": _whisper_input_specs, "ssm": _xlstm_input_specs,
                "hybrid": _zamba_input_specs}

# family -> the decode caches' names in the order its decode takes them
_CACHES = {
    "dense": ("k_cache", "v_cache"),
    "moe": ("k_cache", "v_cache"),
    "vlm": ("k_cache", "v_cache"),
    "encdec": ("k_cache", "v_cache", "xk_cache", "xv_cache"),
    "ssm": ("mh", "mn", "sc", "sn", "sm", "sy"),
    "hybrid": ("ssm_h", "conv_buf", "k_cache", "v_cache"),
}


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family in _FAMILIES:
        return Model(cfg)
    raise ValueError(cfg.family)


def decode_caches_from_specs(model: Model, sp: ShapeSpec, device="meta") -> tuple:
    """Order the decode-state spec dict into the caches tuple each family's
    decode fn expects."""
    specs = model.input_specs(sp)
    return tuple(specs[n] for n in cache_names(model.cfg))


def cache_names(cfg: ArchConfig) -> tuple[str, ...]:
    """The decode caches' names in :func:`decode_caches_from_specs`'s order."""
    if cfg.family not in _CACHES:
        raise ValueError(cfg.family)
    return _CACHES[cfg.family]
