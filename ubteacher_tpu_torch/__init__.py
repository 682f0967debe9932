"""PyTorch/CUDA port of ubteacher_tpu for NVIDIA Hopper (H100).

The JAX package `ubteacher_tpu` is the reference; this package mirrors its
subpackage and module names and imports neither jax nor ubteacher_tpu. The
TPU's Pallas kernels on the ported path are hand-written Hopper kernels under
`ops/kernels/` (CUDA C++ sources in `csrc/`, Triton sources beside their
wrappers), each with a plain PyTorch version that CPU tensors use.
"""
