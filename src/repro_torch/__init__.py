"""MKQ-BERT on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors the JAX package (``configs``, ``core``, ``kernels``,
``models``, ``deploy``, ``checkpoint``, ``serving``, ``optim``, ``data``,
``launch``, ``benchmarks``), so each counterpart sits under the same module
name. The port imports neither ``jax`` nor
``repro``. Its integer kernels are hand-written CUDA for Hopper
(``kernels/csrc``), each beside a plain PyTorch version that CPU tensors
take. Entry points run on the card unless the caller passes
``device="cpu"``.

The model is float32: TF32 is switched off for matmuls and convolutions
here, so the attention einsums stay full fp32 as in the reference.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
