"""Hopper kernels: the histogram family (paper case study, K2-K4), the
scatter-add family (K5-K7), the conflict instrumentation both inline (K1),
and flash attention for the LM serving path's prefill (K8)."""
