"""moe_roofline.prefill: roofline share (%) of one forward of the
program's MoE layer 0 (``models/moe.py`` ``apply_local``) over its own
input from ``roofline_tokens`` of the cell's tokens (the embedding plus
layer 0's attention, normed), timed from outside."""

from perfbench import readers


def read(run):
    return readers.moe_roofline(run, "prefill", backward=False)
