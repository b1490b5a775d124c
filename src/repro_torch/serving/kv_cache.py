"""Slot-state manager: per-layer KV cache with per-slot lengths and optional
int8/int4 quantization.

fp (kv_bits=16): one stacked buffer {'k','v': (L, slots, max_len, Hkv, hd),
'len': (slots,)}. Quantized (kv_bits=8/4): the packed layout {'k_q','v_q':
integer codes (int4 nibble-packed along head_dim), 'k_scale','v_scale':
(L, slots, max_len, Hkv) f32 per-(token, head) scales, 'len': (slots,)}.

Each slot masks and appends at its own cursor, so refilling a finished slot
cannot read the previous occupant's rows. Prefill writes through the
quantizer: the prefill cache stays fp (one forward at full precision) and
``insert_prefill`` quantizes its rows on the way into the slot buffers;
decode appends quantize in ``models/transformer.write_new_kv``. The
prefix-reuse prefill computes in the table's precision, and
``insert_rows`` copies its rows as they are. The buffers
are updated in place on the device they were allocated on. Under a
tensor-parallel plan a rank holds ``num_kv_heads / tp`` heads of every
buffer (``distributed.serving_state_specs``); the cursors are the same on
every rank.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.kv_pack import kv_buffer_keys, quantize_kv
from ..models import api


class SlotKVCache:
    """Slot table over the dense decoder KV cache, on ``device`` (``None``
    means the card; pass ``device='cpu'`` for the CPU). ``kv_heads``: the
    KV heads held here (a tensor-parallel rank's share; default all)."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int,
                 dtype: torch.dtype = torch.float32,
                 kv_bits: int | None = None, device=None,
                 kv_heads: int | None = None):
        from ..device import resolve_device
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.dtype = dtype
        self.kv_bits = cfg.kv_bits if kv_bits is None else kv_bits
        self.device = resolve_device(device)
        self.state = api.decode_state(cfg, slots, max_len, dtype,
                                      per_slot_len=True, kv_bits=self.kv_bits,
                                      device=self.device, kv_heads=kv_heads)

    @classmethod
    def from_plan(cls, plan, slots: int, max_len: int,
                  device=None) -> "SlotKVCache":
        """Slot table with the plan's decode dtype, KV precision and head
        share, so the cache can never disagree with the plan the steps run
        under."""
        return cls(plan.cfg, slots, max_len, dtype=plan.torch_dtype,
                   kv_bits=plan.kv_bits, device=device,
                   kv_heads=plan.kv_heads)

    @property
    def quantized(self) -> bool:
        return self.kv_bits in (8, 4)

    def reset_slot(self, slot: int) -> None:
        """Zero a slot's K/V rows (codes and scales when quantized) and
        rewind its cursor (request eviction)."""
        for key, val in self.state.items():
            if key == "len":
                val[slot] = 0
            else:
                val[:, slot].zero_()

    def insert_prefill(self, slot: int, pstate: dict, length: int,
                       bucket: int, row: int = 0) -> None:
        """Install row ``row`` of a prefilled batch-N fp cache (allocated
        with max_len=bucket) into ``slot`` with the slot cursor at
        ``length``, quantizing the rows on the way in when kv_bits < 16.
        Rows past ``length`` hold prompt padding; they stay masked and are
        overwritten by later decode writes at the slot cursor."""
        if bucket > self.max_len:
            raise ValueError(f"bucket {bucket} exceeds max_len {self.max_len}")
        if self.quantized:
            kq, ks = quantize_kv(pstate["k"][:, row], self.kv_bits)
            vq, vs = quantize_kv(pstate["v"][:, row], self.kv_bits)
            rows = {"k_q": kq, "v_q": vq, "k_scale": ks, "v_scale": vs}
        else:
            rows = {key: pstate[key][:, row] for key in ("k", "v")}
        for key in kv_buffer_keys(self.kv_bits):
            self.state[key][:, slot, :bucket] = rows[key]
        self.state["len"][slot] = length

    def insert_rows(self, slot: int, src: dict, length: int, bucket: int,
                    row: int = 0) -> None:
        """Install row ``row`` of a scratch cache that ALREADY matches this
        table's precision (the prefix-reuse chunked prefill, DESIGN.md §11):
        quantized codes + per-(token, head) scales — or fp rows at kv_bits
        16 — copy directly, no requantization. The scratch may hold more
        than ``bucket`` rows (block-grid rounding); only the first
        ``bucket`` copy."""
        if bucket > self.max_len:
            raise ValueError(f"bucket {bucket} exceeds max_len {self.max_len}")
        for key in kv_buffer_keys(self.kv_bits):
            self.state[key][:, slot, :bucket] = src[key][:, row, :bucket]
        self.state["len"][slot] = length

    def lengths(self) -> np.ndarray:
        return self.state["len"].cpu().numpy()
