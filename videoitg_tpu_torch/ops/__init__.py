"""Ops: attention (oracle + Hopper kernels), resize and preprocessing."""
