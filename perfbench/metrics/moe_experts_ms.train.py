"""moe_experts_ms.train: device ms of a train step of the MoE's
``moe.experts`` stage (the three ``bmm`` and the activation), forward,
recompute and backward."""

from perfbench import stages


def read(run):
    return stages.stage_ms(run, "train", "moe.experts")
