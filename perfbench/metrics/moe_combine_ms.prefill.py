"""moe_combine_ms.prefill: device ms of a prefill batch of the MoE's
``moe.combine`` stage (``y[slot.clamp(...)]``, ``where``,
``combine_inputs``, K5 and the cast): the forward alone."""

from perfbench import stages


def read(run):
    return stages.stage_ms(run, "prefill", "moe.combine")
