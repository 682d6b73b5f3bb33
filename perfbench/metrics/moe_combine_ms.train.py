"""moe_combine_ms.train: device ms of a train step of the MoE's
``moe.combine`` stage (``y[slot.clamp(...)]``, ``where``,
``combine_inputs``, K5 and the cast), forward, recompute and backward."""

from perfbench import stages


def read(run):
    return stages.stage_ms(run, "train", "moe.combine")
