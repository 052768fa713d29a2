"""Hand-written Hopper kernels (CUDA C++ under `csrc/`, built by `_build`)
with their plain PyTorch versions in `ref`; `ops` dispatches by device."""
