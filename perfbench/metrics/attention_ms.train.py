"""attention_ms.train: device ms of a train step of the program's
``attention`` stage (``models/attention.py`` ``attend``: the
projections, RoPE, the core and the output projection), forward,
recompute and backward."""

from perfbench import stages


def read(run):
    return stages.stage_ms(run, "train", "attention")
