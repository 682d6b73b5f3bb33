"""Hopper kernels: the histogram family (paper case study, K2-K4) and
the conflict instrumentation they inline (K1)."""
