"""Architecture configs of the LM model zoo.

Parameters are nested dicts of tensors with *stacked* per-layer leaves (a
leading L dimension), the reference package's layout; the port runs a layer
stack as a Python loop over views ``w[l]`` of those leaves. The meshes are
:mod:`repro_torch.launch.mesh`'s.
:func:`active_param_count` gives a step's model FLOPs (6 · active
parameters · tokens).

The sharding rules are the reference's: TP over ``model`` (column-parallel
QKV/up, row-parallel O/down, vocab-sharded embeddings), ZeRO-3/FSDP over
``data`` (and ``pod`` when multi-pod). A rule is written as the reference's
``PartitionSpec``, a tuple of one entry a tensor dim (a mesh axis name, a
tuple of them, or None), and becomes DTensor placements
(:class:`Sharding`): an entry naming axis ``a`` on tensor dim ``i`` is
``Shard(i)`` on mesh dim ``a``; a tuple ``("pod", "data")`` puts
``Shard(i)`` on both, and DTensor shards over mesh dims left to right,
which is JAX's major-to-minor order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
Shapes = SHAPES


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_act: str = "silu_gated"  # or "gelu"
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_shared_d_ff: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel
    moe_capacity_factor: float = 1.25
    # "einsum": GShard one-hot dispatch (SPMD-friendly baseline)
    # "scatter": sort-free scatter/gather dispatch — no O(T·E·C) one-hots,
    #            no dispatch matmul flops (see EXPERIMENTS.md §Perf/moe)
    moe_dispatch: str = "einsum"
    # pad the expert dim so it divides the `model` axis and EP sharding
    # engages (e.g. qwen2-moe 60 -> 64); padded experts are router-masked
    moe_pad_experts: int = 0
    # repeat-KV + zero-pad attention heads to this count inside train/prefill
    # attention so the score tensor's head dim divides the `model` axis
    # (llava 56H kv8 -> 64 MHA-view heads). Exact-math: repeat preserves the
    # GQA q->kv mapping; padded q heads are sliced off before the output
    # projection. Decode is untouched (memory-bound, caches keep KH heads).
    tp_pad_heads: int = 0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    slstm_every: int = 0  # xlstm: every k-th layer is sLSTM
    attn_every: int = 0  # zamba2: shared attn block after every k SSM layers
    sliding_window: int = 0  # cap attention window (hybrid long-context)
    # --- enc-dec / frontends ---
    encoder_layers: int = 0
    frontend: str = "none"  # "audio" | "vision" (STUB: embeddings provided)
    frontend_tokens: int = 0  # patches/frames prepended to the sequence
    # --- numerics / memory / runtime ---
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    optimizer: str = "adamw"  # "adamw" | "adafactor"
    optimizer_dtype: str = "float32"  # bf16 moments for the giants
    accum_steps: int = 1  # gradient accumulation (microbatching) for train
    act_shard: str = "none"  # "seq": Megatron-SP residual-stream sharding
    # long-context handling: "full" attention or "skip" (arch can't do 500k)
    long_context: str = "skip"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def supports_shape(self, shape: str) -> tuple[bool, str]:
        if shape == "long_500k" and self.long_context == "skip":
            return False, (
                "pure full-attention arch: 500k dense decode is architecturally "
                "meaningless (see DESIGN.md shape skips)"
            )
        return True, ""


def param_count(cfg: ArchConfig) -> int:
    """Approximate parameter count (embeddings + stacks), for roofline."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    total = V * D  # embed
    if not cfg.tie_embeddings:
        total += V * D
    attn = D * H * hd + 2 * D * KH * hd + H * hd * D
    if cfg.mlp_act == "silu_gated":
        mlp = 3 * D * F
    else:
        mlp = 2 * D * F
    if cfg.family == "moe":
        moe = cfg.moe_experts * 3 * D * cfg.d_ff + D * cfg.moe_experts
        if cfg.moe_shared_experts:
            moe += 3 * D * cfg.moe_shared_d_ff
        if cfg.moe_dense_residual:
            moe += 3 * D * cfg.d_ff
        total += L * (attn + moe + 2 * D)
    elif cfg.family in ("ssm",):
        din, N = cfg.d_inner, cfg.ssm_state
        ssm = D * (2 * din + 2 * N + cfg.ssm_heads) + din * D + 2 * D
        total += L * ssm
    elif cfg.family == "hybrid":
        din, N = cfg.d_inner, cfg.ssm_state
        ssm = D * (2 * din + 2 * N + cfg.ssm_heads) + din * D + 2 * D
        total += L * ssm + (attn + 3 * D * F + 2 * D)  # one shared block
    else:
        total += L * (attn + mlp + 2 * D)
        if cfg.encoder_layers:
            total += cfg.encoder_layers * (attn + mlp + 2 * D)
            total += cfg.n_layers * (attn + 2 * D)  # cross-attention
    return int(total)


def active_param_count(cfg: ArchConfig) -> int:
    """Active params per token (MoE: top-k experts only) — for MODEL_FLOPS."""
    if cfg.family != "moe":
        return param_count(cfg)
    D, L = cfg.d_model, cfg.n_layers
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = D * H * hd + 2 * D * KH * hd + H * hd * D
    moe_active = cfg.moe_top_k * 3 * D * cfg.d_ff + D * cfg.moe_experts
    if cfg.moe_shared_experts:
        moe_active += 3 * D * cfg.moe_shared_d_ff
    if cfg.moe_dense_residual:
        moe_active += 3 * D * cfg.d_ff
    total = 2 * cfg.vocab_size * D + L * (attn + moe_active + 2 * D)
    return int(total)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshAxes:
    data: Any = "data"  # str or tuple (("pod","data") when multi-pod)
    model: str = "model"


def fsdp_axes(mesh) -> MeshAxes:
    if "pod" in mesh.mesh_dim_names:
        return MeshAxes(data=("pod", "data"), model="model")
    return MeshAxes(data="data", model="model")


# Param-leaf sharding is keyed on the leaf's path suffix. Conventions:
#   *_col : (in, out) column-parallel  -> P(data, model)
#   *_row : (in, out) row-parallel     -> P(model, data)
#   embed : (vocab, d)                 -> P(model, data)
#   *_exp : (E, in, out) expert        -> P(model, data, None)
#   bias_col : (out,) column bias      -> P(model)
#   norm / scalars                     -> replicated
def leaf_spec(path: str, ndim: int, ax: MeshAxes, stacked: bool) -> tuple:
    """The leaf's ``PartitionSpec`` entries (a stacked leaf's layer dim
    first, unsharded)."""
    pre = (None,) if stacked else ()
    if path.endswith("out_embed"):  # (D, V): vocab over model, D replicated
        return (None, ax.model)
    if path.endswith("embed"):  # (V, D): vocab over model (the lookup needs D replicated)
        return (ax.model, None)
    if path.endswith("_col"):
        if ndim - len(pre) == 1:  # column bias
            return (*pre, ax.model)
        return (*pre, ax.data, ax.model)
    if path.endswith("_row"):
        return (*pre, ax.model, ax.data)
    if path.endswith("_exp"):  # (E, in, out)
        return (*pre, ax.model, ax.data, None)
    if path.endswith("_dp"):  # shard first non-stack dim over data only
        return (*pre, ax.data)
    return pre


def tree_paths(tree: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(tree_paths(v, p))
        else:
            out[p] = v
    return out


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    names = mesh.mesh_dim_names
    if isinstance(ax, tuple):
        return math.prod(mesh.shape[names.index(a)] for a in ax)
    return int(mesh.shape[names.index(ax)])


@dataclass(frozen=True)
class Sharding:
    """A ``PartitionSpec`` on a ``DeviceMesh``: the reference's
    ``NamedSharding``. ``spec`` has one entry a tensor dim."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh dim: ``Shard(i)`` where spec
        entry ``i`` names the dim's axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [i for i, a in enumerate(self.spec)
                    if a == name or (isinstance(a, tuple) and name in a)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """Each rank's local shape (the rules keep every sharded dim
        divisible)."""
        return tuple(int(n) // _axis_size(self.mesh, a) for n, a in
                     zip(shape, tuple(self.spec) + (None,) * (len(shape) - len(self.spec))))


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= int(d)
    return tuple(reversed(out))


def from_local(local: torch.Tensor, mesh, placements, shape):
    """``local`` as this rank's shard of a DTensor of global ``shape`` laid
    out by ``placements`` on ``mesh``: no collective, no check."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=contiguous_stride(shape))


def shardings_for(params: dict, mesh,
                  stacked_prefixes: tuple[str, ...] = ("layers", "encoder_layers")) -> dict:
    """Mirror the param tree with :class:`Sharding` objects per the leaf rules.

    Dims that don't divide their assigned mesh axis fall back to replicated
    (the reference's jit in_shardings require exact divisibility)."""
    ax = fsdp_axes(mesh)

    def rec(tree, path):
        if isinstance(tree, dict):
            return {k: rec(v, f"{path}/{k}" if path else k) for k, v in tree.items()}
        stacked = any(path.startswith(p) or f"/{p}/" in f"/{path}/" for p in stacked_prefixes)
        ndim = len(tree.shape)
        spec = leaf_spec(path.split("/")[-1], ndim, ax, stacked)[:ndim]
        fixed = tuple(
            a if a is not None and tree.shape[i] % _axis_size(mesh, a) == 0 else None
            for i, a in enumerate(spec)
        )
        return Sharding(mesh, fixed)

    return rec(params, "")


def struct(shape, dtype=torch.bfloat16) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` with no storage, on the ``meta``
    device (under the dry run's ``FakeTensorMode`` a fake one). The
    reference's ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")
