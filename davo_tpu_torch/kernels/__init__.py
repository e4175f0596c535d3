"""Hand-written CUDA kernels (sources in ../csrc) with their plain
PyTorch versions. A wrapper launches its kernel for a CUDA tensor (or
raises) and runs the plain version only for a tensor on the CPU."""
