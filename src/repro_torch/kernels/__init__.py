"""Hopper kernels: the histogram family (paper case study, K2-K4), the
scatter-add family (K5-K7) and the conflict instrumentation both inline
(K1)."""
