"""Model configuration dataclass, the dry run's shapes and its inputs.

The field list matches the JAX package's ``ModelConfig`` one for one, so a
``dataclasses.asdict`` of either side round-trips through the shared artifact
meta (``ARTIFACT.json``). There is no framework dtype property: the port
resolves ``dtype`` with :data:`TORCH_DTYPES`. ``SHAPES`` and
``shape_applicable`` are the JAX package's; ``input_specs`` returns tensors
on the ``meta`` device (shapes and dtypes, no storage) where JAX returns
``ShapeDtypeStruct``s.
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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Full-attention archs skip long_500k (DESIGN.md §5); SSM/hybrid run it.
SUBQUADRATIC_FAMILIES = ("xlstm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, "full-attention arch: 500k decode skipped (DESIGN.md §5)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> dict:
    """Empty stand-ins for every model input of ``shape`` (the JAX
    package's keys, shapes and dtypes), on ``device``: ``meta`` by default,
    tensors with no storage. A decode shape's ``cache`` is None (its state
    is family-specific: ``models.api.decode_state``)."""
    B, S = shape.global_batch, shape.seq_len
    mk = lambda s, dt: torch.empty(s, dtype=dt, device=device)
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": mk((B, 1), i32), "cache": None}
    cd = cfg.torch_dtype
    specs = {}
    if cfg.input_kind == "embeds":        # audio frontend stub: frame embeddings
        specs["src_embeds"] = mk((B, S, cfg.d_model), cd)
        specs["tokens"] = mk((B, S), i32)
    elif cfg.input_kind == "tokens+patches":
        specs["tokens"] = mk((B, S), i32)
        specs["patch_embeds"] = mk((B, cfg.num_patches, cfg.d_model), cd)
        specs["patch_mask"] = mk((B, S), torch.bool)
    else:
        specs["tokens"] = mk((B, S), i32)
    if shape.kind == "train":
        specs["labels"] = mk((B, S), i32)
    return specs


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    """QAT hyperparameters (paper §5.2): the JAX package's fields and
    defaults. Its training loop reads neither ``microbatch`` nor
    ``grad_compression`` (only its dry run reads ``microbatch``), and
    neither does the port's; gradient compression is
    ``distributed.compression.compressed_grad_mean``."""
    lr_weights: float = 1e-5
    lr_act_scale: float = 0.01
    lr_weight_scale: float = 0.001
    warmup_frac: float = 0.10
    total_steps: int = 1000
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip: float = 1.0
    alpha: float = 10.0         # output-distill weight
    beta: float = 1.0           # MINI-distill weight
    microbatch: int = 0         # 0 = no grad accumulation
    grad_compression: bool = False
