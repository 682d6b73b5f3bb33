"""moe_experts_ms.prefill: device ms of a prefill batch of the MoE's
``moe.experts`` stage (the three ``bmm`` and the activation): the
forward alone."""

from perfbench import stages


def read(run):
    return stages.stage_ms(run, "prefill", "moe.experts")
