"""minitron-4b [dense]: pruned nemotron, 256k vocab.
[arXiv:2407.14679; hf]"""
from repro_torch.models.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=1e4,
    accum_steps=2,
    long_context="skip",
)
