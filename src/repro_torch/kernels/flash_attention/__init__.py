"""Hopper flash attention (K8): the LM serving path's prefill attention."""
from repro_torch.kernels.flash_attention import ops, ref  # noqa: F401
