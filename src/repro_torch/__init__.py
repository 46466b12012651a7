"""PyTorch/CUDA port of the Sector/Sphere reproduction.

A second package beside the JAX reference ``repro``: same module layout,
same public API, records on torch tensors, and every TPU kernel on the
ported path replaced by a kernel written by hand for NVIDIA Hopper.  It
imports nothing of JAX and nothing of ``repro``.
"""
