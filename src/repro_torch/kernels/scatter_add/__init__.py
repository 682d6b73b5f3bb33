"""Hopper kernels: the scatter-add family (MoE dispatch and combine,
embedding gradients; K5-K7)."""
from repro_torch.kernels.scatter_add import ops, ref  # noqa: F401
