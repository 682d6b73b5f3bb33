"""moe_drop.mla_prefill: the share (%) of the held experts' routed rows
past their capacity over the traced slice: 100 x (1 - kept / routed) of
``repro_moe_rows_total``."""

from perfbench import stages_mla


def read(run):
    return stages_mla.drop_percent(run)
