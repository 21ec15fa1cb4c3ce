"""whisper-small [audio]: enc-dec, conv frontend STUB (precomputed frame
embeddings). [arXiv:2212.04356; unverified]

Deviations: encoder positions sinusoidal (as whisper), decoder uses RoPE
instead of learned positions so 32k decode shapes are well-defined
(whisper's learned table stops at 448) — noted in DESIGN.md.
"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    qkv_bias=True,
    mlp_act="gelu",
    frontend="audio",
    frontend_tokens=1500,
    rope_theta=1e4,
    long_context="skip",
)
