"""moe_held.mla_prefill: the share (%) of the traced slice's routed rows
(tokens x top_k x MoE layers) that land on the experts this card holds
(``repro_moe_rows_total``, outcome "routed"): how near the card's expert
load is to the uniform 8 / 256 = 3.125%."""

from perfbench import stages_mla


def read(run):
    return stages_mla.held_percent(run)
