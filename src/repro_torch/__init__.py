"""PyTorch port of the MultiVic reproduction for the NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
nothing of it (nor JAX).  Its kernels are hand-written for Hopper
(``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use, and run
for CUDA tensors; CPU tensors take each kernel's plain PyTorch version.
Entry points run on the card unless the caller asks for the CPU.
"""
