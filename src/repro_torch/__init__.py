"""Dash: scalable hashing, ported to PyTorch and CUDA for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held against;
this package imports nothing from it. ``repro_torch.core`` mirrors
``repro.core``, ``repro_torch.kernels`` holds the CUDA kernels that replace
the Pallas TPU kernels, and ``repro_torch.interop`` carries table state
across between the two.
"""
