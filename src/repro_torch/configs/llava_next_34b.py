"""llava-next-34b [vlm]: anyres tiling backbone; vision frontend STUB
(precomputed patch embeddings + learned projector).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    frontend_tokens=576,
    rope_theta=1e6,
    accum_steps=8,
    act_shard="seq",
    long_context="skip",
)
