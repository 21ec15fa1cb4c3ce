"""zamba2-7b [hybrid]: Mamba2 stack + ONE shared attention/MLP block applied
after every 6 SSM layers (weight sharing), sliding-window KV (the SSM carries
long-range state). ssm_state=64. [arXiv:2411.15242; unverified]
Runs long_500k (O(1)-in-seq decode via recurrent state + windowed KV)."""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_heads=112,   # d_inner 7168 / head dim 64
    ssm_expand=2,
    ssm_chunk=128,
    attn_every=6,
    sliding_window=4096,
    rope_theta=1e4,
    accum_steps=4,
    long_context="run",
)
