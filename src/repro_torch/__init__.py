"""DOPPLER in PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The layout mirrors ``repro`` (``core/``, ``graphs/``, ``kernels/<name>/``),
with the hand-written CUDA sources in ``csrc/``.  The package imports
torch and numpy only; it never imports jax or ``repro``.

The policy MLPs must run in full float32 to stay within 1e-5 of the JAX
reference, so importing the package turns TF32 off for matmuls and
cuDNN in this process.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
