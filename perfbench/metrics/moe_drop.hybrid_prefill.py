"""moe_drop.hybrid_prefill: the share (%) of the MoE's routed rows past
their expert's capacity over the traced slice: 100 x (1 - kept / routed)
of ``repro_moe_rows_total``."""

from perfbench import stages_hybrid


def read(run):
    return stages_hybrid.drop_percent(run)
