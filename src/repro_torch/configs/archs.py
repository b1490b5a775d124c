"""Architectures the port serves: the paper's own BERT configurations and
the dense decoders of the decode serving path (copied from the JAX
package's registry, same fields and values)."""
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


# --- dense decoders -----------------------------------------------------------
# [hf:stabilityai/stablelm-2-1_6b; unverified] -- the JAX serve CLI's default
_reg(ModelConfig(
    name="stablelm-3b", family="dense", num_layers=32, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=6912, vocab_size=50304,
    act="swiglu", norm="ln", qkv_bias=False))

# GQA [arXiv:2403.17297; hf] -- the GQA shape of the decode-attention checks
_reg(ModelConfig(
    name="internlm2-20b", family="dense", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=92544,
    act="swiglu", rope_theta=1e6))
