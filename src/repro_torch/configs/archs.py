"""The paper's own BERT configurations (the port serves the bert family)."""
from __future__ import annotations

from .base import ModelConfig

ARCHS: dict[str, ModelConfig] = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# TinyBERT4 student (Jiao et al. 2019): L4 d312 h12 dff1200
_reg(ModelConfig(
    name="tinybert4", family="bert", num_layers=4, d_model=312,
    num_heads=12, num_kv_heads=12, d_ff=1200, vocab_size=30522,
    qkv_bias=True, out_bias=True, norm="ln", act="gelu", rope=False,
    causal=False, learned_pos=True, dtype="float32", remat=False))

# BERT-base teacher shape (Devlin et al. 2018)
_reg(ModelConfig(
    name="bert-base", family="bert", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=30522,
    qkv_bias=True, out_bias=True, norm="ln", act="gelu", rope=False,
    causal=False, learned_pos=True, dtype="float32", remat=False))
