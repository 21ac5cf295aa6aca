"""Attention kernels (CUDA sources in ``csrc/``) and their ops."""
