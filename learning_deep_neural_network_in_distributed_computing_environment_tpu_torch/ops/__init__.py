"""Attention ops and the hand-written CUDA flash-attention kernels."""
