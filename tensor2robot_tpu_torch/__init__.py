"""tensor2robot_tpu_torch: the PyTorch/CUDA port of tensor2robot_tpu.

The JAX package `tensor2robot_tpu` is the reference; this package mirrors
its subpackage layout, imports torch, numpy and the standard library only,
and runs its entry points on the CUDA card unless the caller passes
device="cpu".
"""
