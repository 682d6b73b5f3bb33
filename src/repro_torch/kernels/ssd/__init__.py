"""Hopper chunked SSD: Mamba-2's state-space duality as three kernels."""
