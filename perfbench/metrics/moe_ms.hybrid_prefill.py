"""moe_ms.hybrid_prefill: device ms of a prefill batch of the MoE layers:
the union of the ``moe.*`` stages (route, dispatch, experts, combine)
and ``moe.shared`` (the shared expert's MLP)."""

from perfbench import stages_hybrid


def read(run):
    return stages_hybrid.union_ms(run, stages_hybrid.MOE)
