"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``).

Each kernel package holds ``ref.py`` (the plain PyTorch version) and
``ops.py`` (the wrapper: checks, launch on the current stream, launch
count).  A wrapper takes the plain version only for tensors on the CPU;
for a CUDA tensor it launches the kernel or raises.
"""
