"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + 4 shared experts
(always-on, fused as one 4x-wide shared FFN). [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    moe_experts=60,
    moe_top_k=4,
    moe_shared_experts=4,
    moe_shared_d_ff=5632,
    # beyond-paper perf: pad expert dim to 64 so EP shards over model=16
    # (60 % 16 != 0 left experts replicated — EXPERIMENTS.md §Perf/moe it.3)
    moe_pad_experts=64,
    rope_theta=1e6,
    accum_steps=2,
    long_context="skip",
)
