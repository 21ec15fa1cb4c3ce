"""arctic-480b [moe]: 128 experts top-2 + dense residual FFN in parallel.
[hf:Snowflake/snowflake-arctic-base; hf]

Memory fitting: bf16 Adam moments, FSDP + 16-way EP over `model`.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe_experts=128,
    moe_top_k=2,
    moe_dense_residual=True,
    optimizer_dtype="bfloat16",
    rope_theta=1e6,
    accum_steps=8,
    act_shard="seq",
    long_context="skip",
)
