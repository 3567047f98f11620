"""Numerics core and the hand-written CUDA kernels of the PyTorch port."""
