"""Operators of the port: plain PyTorch pieces and the CUDA kernels' wrappers."""
