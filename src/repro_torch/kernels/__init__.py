"""Kernels written by hand for NVIDIA Hopper, one package per TPU kernel
of ``repro.kernels`` that the port has reached.

Each kernel ships as <name>/{csrc/*.cu (the CUDA source), kernel.py
(build, load and launch, with a launch counter), ops.py (the entry
points, routed by the tensors' device), ref.py (the plain PyTorch
version)}; tests hold ops on the CPU against the JAX package and the
kernel against ref.py on the card.
"""
