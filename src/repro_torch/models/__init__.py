"""The LM substrate's dense serving path: layers, attention (prefill through
K8), the gated MLP and the causal LM, as functional parameter dicts."""
