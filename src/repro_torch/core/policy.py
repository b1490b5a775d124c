"""Mixed-precision quantization policy (paper §5.2/§5.3).

The paper quantizes from the LAST layer backwards into int4 (higher layers are
more robust), keeps the rest int8, and never quantizes the embedding;
LayerNorm / softmax / GELU stay fp32 (enforced structurally: only linear
matmuls go through quantized paths).

``QuantPolicy`` is pure data — models consume per-layer bit-vectors so the
policy composes with ``lax.scan`` over stacked layers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ["QuantPolicy"]


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Which layers get which bit-width.

    mode:        'none' (fp baseline) | 'fake' (QAT fake-quant) | 'int' (deployed)
    int4_layers: explicit layer indices quantized to 4 bits, or use last_k_int4.
    default_bits: bits for the remaining (non-int4) layers — 8 per the paper.
    grad_mode:   'mse' (MKQ-BERT) | 'ste' (KDLSQ baseline).
    act_bits_follow: activations use the same bits as the layer's weights
                 (paper: true 4-bit activations — unlike KDLSQ's int8 acts).
    """

    num_layers: int
    mode: str = "fake"
    int4_layers: Optional[Sequence[int]] = None
    last_k_int4: int = 0
    default_bits: int = 8
    grad_mode: str = "mse"
    act_bits_follow: bool = True
    act_bits_override: Optional[int] = None  # e.g. KDLSQ: weights 4-bit, acts 8-bit
    per_row_weight_scale: bool = True
    quant_embedding: bool = False  # paper: never

    def __post_init__(self):
        if self.mode not in ("none", "fake", "int"):
            raise ValueError(f"bad mode {self.mode!r}")
        if self.grad_mode not in ("mse", "ste"):
            raise ValueError(f"bad grad_mode {self.grad_mode!r}")

    def weight_bits(self, layer: int) -> Optional[int]:
        if self.mode == "none":
            return None
        if self.int4_layers is not None and layer in set(self.int4_layers):
            return 4
        if self.last_k_int4 and layer >= self.num_layers - self.last_k_int4:
            return 4
        return self.default_bits

    def act_bits(self, layer: int) -> Optional[int]:
        if self.mode == "none":
            return None
        if self.act_bits_override is not None:
            return self.act_bits_override
        wb = self.weight_bits(layer)
        return wb if self.act_bits_follow else self.default_bits

    def weight_bits_vector(self) -> np.ndarray:
        """Per-layer weight bits as an int array (0 = unquantized) for scan bodies."""
        return np.array(
            [self.weight_bits(l) or 0 for l in range(self.num_layers)], dtype=np.int32
        )

    def act_bits_vector(self) -> np.ndarray:
        return np.array(
            [self.act_bits(l) or 0 for l in range(self.num_layers)], dtype=np.int32
        )

    @classmethod
    def from_dict(cls, d: dict) -> "QuantPolicy":
        """Inverse of ``dataclasses.asdict`` after a JSON round trip (the
        DeployedModel artifact meta — DESIGN.md §9). Unknown keys are
        dropped so artifacts from a newer build still load."""
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        if d.get("int4_layers") is not None:
            d["int4_layers"] = tuple(d["int4_layers"])
        return cls(**d)

    def describe(self) -> str:
        i4 = [l for l in range(self.num_layers) if self.weight_bits(l) == 4]
        return (
            f"QuantPolicy(mode={self.mode}, grad={self.grad_mode}, "
            f"int4_layers={i4}, default={self.default_bits}b)"
        )
