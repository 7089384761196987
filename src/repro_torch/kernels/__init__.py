"""Attention kernels: hand-written CUDA for Hopper plus their plain
PyTorch versions, dispatched by device in ``ops``."""
