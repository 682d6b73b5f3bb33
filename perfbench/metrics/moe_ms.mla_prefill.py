"""moe_ms.mla_prefill: device ms of a prefill batch of the MoE layers:
the union of the ``moe.*`` stages (route, dispatch, experts, combine) and
``moe.shared`` (the shared expert's MLP)."""

from perfbench import stages_mla


def read(run):
    return stages_mla.union_ms(run, stages_mla.MOE)
