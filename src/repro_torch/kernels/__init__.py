"""Kernels written by hand for NVIDIA Hopper, one package per TPU kernel
of ``repro.kernels`` that the port has reached.

Each kernel ships as <name>/{csrc/*.cu (the CUDA sources), kernel.py
(build, load and launch, with a launch counter), ops.py (the entry
points, routed by the tensors' device), ref.py (the plain PyTorch
version)}; :mod:`._build` compiles every source with ``nvcc``.  Tests
hold ops on the CPU against the JAX package and each kernel against
ref.py on the card.
"""
from repro_torch.kernels.bucket_partition.ops import (  # noqa: F401
    bucket_dest, bucket_partition, bucket_scatter)
from repro_torch.kernels.bucket_partition.ref import (  # noqa: F401
    bucket_blocks_ref, bucket_dest_ref, dest_from_blocks)
from repro_torch.kernels.kmeans_assign import kmeans_assign  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.rg_lru_scan import rg_lru_scan  # noqa: F401
