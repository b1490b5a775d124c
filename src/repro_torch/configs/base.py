"""Model configuration dataclass.

The field list matches the JAX package's ``ModelConfig`` one for one, so a
``dataclasses.asdict`` of either side round-trips through the shared artifact
meta (``ARTIFACT.json``). There is no framework dtype property: the port
resolves ``dtype`` with :data:`TORCH_DTYPES`.
"""
from __future__ import annotations

import dataclasses

import torch

#: ``ModelConfig.dtype`` names -> torch dtypes
TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | xlstm | hybrid | encdec | vlm | bert
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // num_heads
    qkv_bias: bool = False
    out_bias: bool = False
    norm: str = "rms"           # rms | ln
    act: str = "swiglu"         # swiglu | gelu  (gelu => non-gated 2-matmul FFN)
    rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True
    tie_embeddings: bool = False
    learned_pos: bool = False   # BERT-style positional embeddings
    # MoE
    num_experts: int = 0
    top_k: int = 0
    shared_expert_d_ff: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 512
    moe_impl: str = "dense"
    router_aux_coef: float = 0.001
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_every: int = 0
    slstm_every: int = 0
    # VLM
    num_patches: int = 0
    input_kind: str = "tokens"  # tokens | embeds | tokens+patches
    # execution
    attn_chunk_threshold: int = 2048
    attn_chunk: int = 1024
    attn_seq_shard: bool = False
    kv_bits: int = 16                  # serving KV cache: 16 (fp) | 8 | 4
    dp_axes: tuple = ("data",)
    fused_proj: bool = False
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """Inverse of ``dataclasses.asdict`` after a JSON round trip: JSON
        turns the ``dp_axes`` tuple into a list. Unknown keys are dropped so
        artifacts written by a newer build still load."""
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        d["dp_axes"] = tuple(d.get("dp_axes", ("data",)))
        return cls(**d)
