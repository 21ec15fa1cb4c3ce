"""Config registry: the 10 assigned architectures + reduced smoke variants.

``get_config(name)`` returns the full published config; ``reduced_config``
returns a same-family miniature (few layers, narrow width, tiny vocab, few
experts) for CPU smoke tests — full configs are exercised only via the
dry-run (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.base import ArchConfig

ARCHS = [
    "whisper-small",
    "qwen2-0.5b",
    "granite-3-8b",
    "llama3-405b",
    "minitron-4b",
    "llava-next-34b",
    "xlstm-350m",
    "arctic-480b",
    "qwen2-moe-a2.7b",
    "zamba2-7b",
]

_MODULES = {
    "whisper-small": "whisper_small",
    "qwen2-0.5b": "qwen2_0_5b",
    "granite-3-8b": "granite_3_8b",
    "llama3-405b": "llama3_405b",
    "minitron-4b": "minitron_4b",
    "llava-next-34b": "llava_next_34b",
    "xlstm-350m": "xlstm_350m",
    "arctic-480b": "arctic_480b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "zamba2-7b": "zamba2_7b",
}


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def reduced_config(name: str, dtype: str = "float32") -> ArchConfig:
    """Miniature same-family config for CPU smoke tests."""
    cfg = get_config(name)
    common = {
        "d_model": 64,
        "n_heads": 4,
        "n_kv_heads": 2 if cfg.n_kv_heads < cfg.n_heads else 4,
        "vocab_size": 128,
        "dtype": dtype,
        "remat": False,
    }
    if cfg.family == "encdec":
        return dataclasses.replace(
            cfg, n_layers=2, encoder_layers=2, d_ff=128,
            frontend_tokens=32, **common
        )
    if cfg.family == "moe":
        return dataclasses.replace(
            cfg,
            n_layers=2,
            d_ff=32,
            moe_experts=8,
            moe_top_k=2,
            moe_shared_d_ff=64 if cfg.moe_shared_experts else 0,
            **common,
        )
    if cfg.family == "ssm":
        return dataclasses.replace(
            cfg, n_layers=4, d_ff=0, slstm_every=2, ssm_chunk=32, **common
        )
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg,
            n_layers=5,
            d_ff=128,
            attn_every=2,
            ssm_state=16,
            ssm_heads=8,   # d_inner 128 / head dim 16
            ssm_chunk=32,
            sliding_window=64,
            **common,
        )
    # dense / vlm
    extra = {"frontend_tokens": 16} if cfg.frontend == "vision" else {}
    return dataclasses.replace(cfg, n_layers=2, d_ff=128, **extra, **common)
