"""Operators of the port: hand-written CUDA kernels (`csrc/`), their
build (`_build`) and their PyTorch wrappers (`kernels/`)."""
