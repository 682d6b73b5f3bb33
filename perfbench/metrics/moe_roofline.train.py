"""moe_roofline.train: roofline share (%) of one forward and backward of
the program's MoE layer 0 (``models/moe.py`` ``apply_local``) over its
own input from a train batch of the cell's tokens (the embedding plus
layer 0's attention, normed), timed from outside."""

from perfbench import readers


def read(run):
    return readers.moe_roofline(run, "train", backward=True)
