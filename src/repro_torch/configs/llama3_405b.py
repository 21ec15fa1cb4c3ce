"""llama3-405b [dense]: GQA kv=8, 128k vocab. [arXiv:2407.21783; unverified]

Memory fitting (DESIGN.md §4): bf16 Adam moments, FSDP over data axis.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=5e5,
    optimizer_dtype="bfloat16",
    accum_steps=16,
    # act_shard="seq" measured 10x WORSE collectives at this scale: the SP
    # resharding constraints make the partitioner all-gather full un-TP'd
    # f32 weights in the backward dots (EXPERIMENTS.md §Perf/llama it.1).
    act_shard="none",
    long_context="skip",
)
