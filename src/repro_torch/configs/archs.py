"""Architectures the port serves: the paper's own BERT configurations, the
dense decoders of the decode serving path, the vlm of the long-context
prefill path, the MoE decoders, the encoder-decoder, the Mamba2 hybrid and
xLSTM (copied from the JAX package's registry, same fields and values:
every arch of that registry is here)."""
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

# QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]
_reg(ModelConfig(
    name="qwen1.5-110b", family="dense", num_layers=80, d_model=8192,
    num_heads=64, num_kv_heads=8, d_ff=49152, vocab_size=152064,
    qkv_bias=True, act="swiglu", rope_theta=1e6))

# GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]
_reg(ModelConfig(
    name="qwen2.5-32b", family="dense", num_layers=64, d_model=5120,
    num_heads=40, num_kv_heads=8, d_ff=27648, vocab_size=152064,
    qkv_bias=True, act="swiglu", rope_theta=1e6))


# --- vlm -------------------------------------------------------------------
# anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified];
# Mistral-7B backbone; patch embeddings stubbed (anyres 2x576 grid).
_reg(ModelConfig(
    name="llava-next-mistral-7b", family="vlm", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
    act="swiglu", rope_theta=1e6, num_patches=1152,
    input_kind="tokens+patches"))


# --- moe -------------------------------------------------------------------
# 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
_reg(ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=151936,
    num_experts=60, top_k=4, expert_d_ff=1408, shared_expert_d_ff=5632,
    qkv_bias=True, act="swiglu"))

# 40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
_reg(ModelConfig(
    name="granite-moe-3b-a800m", family="moe", num_layers=32, d_model=1536,
    num_heads=24, num_kv_heads=8, d_ff=512, vocab_size=49155,
    num_experts=40, top_k=8, expert_d_ff=512, shared_expert_d_ff=0,
    act="swiglu"))


# --- audio enc-dec ---------------------------------------------------------
# enc-dec, multimodal [arXiv:2308.11596; hf]; frontend stubbed (frame embeds).
_reg(ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=24,
    enc_layers=12, dec_layers=12, d_model=1024, num_heads=16,
    num_kv_heads=16, d_ff=4096, vocab_size=256206, act="gelu", norm="ln",
    input_kind="embeds"))


# --- hybrid ----------------------------------------------------------------
# Mamba2 + shared attn blocks [arXiv:2411.15242; hf]
_reg(ModelConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    attn_every=6))

# --- ssm -------------------------------------------------------------------
# sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]. d_ff=0: no std FFN.
_reg(ModelConfig(
    name="xlstm-1.3b", family="xlstm", num_layers=48, d_model=2048,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    slstm_every=8, ssm_expand=2, ssm_chunk=256, rope=False))

#: the archs of the dry run's grid (the JAX package's ``ASSIGNED``)
ASSIGNED = [
    "stablelm-3b", "internlm2-20b", "qwen1.5-110b", "qwen2.5-32b",
    "xlstm-1.3b", "seamless-m4t-medium", "llava-next-mistral-7b",
    "qwen2-moe-a2.7b", "granite-moe-3b-a800m", "zamba2-2.7b",
]
