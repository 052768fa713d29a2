"""PyTorch/CUDA port of the `repro` package (spatially parallel CNN
training, paper §III-§VI) for an NVIDIA H100.

The JAX package `repro` stays the reference; this package mirrors it module
for module and imports only torch, numpy and the standard library.  Public
functions keep the reference's layouts: NHWC activations, HWIO conv
weights, and the same parameter-tree names.  Entry points run on CUDA
unless the caller asks for the CPU; on a CUDA tensor every forward conv
runs through the hand-written kernel in `kernels/csrc/conv2d.cu`.
"""
