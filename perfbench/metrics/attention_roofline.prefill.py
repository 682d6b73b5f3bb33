"""attention_roofline.prefill: roofline share (%) of one call of the
program's self-attention on layer 0's weights (``models/attention.py``
``attend``: projections and the causal core, K8 on the card) at the
traffic's ``attention_shape``, timed from outside."""

from perfbench import readers


def read(run):
    return readers.attention_roofline(run, "prefill")
