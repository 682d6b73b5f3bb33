"""mfu.mla_prefill: the window's model FLOPs (``counts_mla.py``: the MLA
projections and causal attention at q·k 192 and v 128, the dense FFNs,
the router, the held experts at their expected rows, the shared expert,
the head) over its time and the card's dense bf16 peak (%)."""

from perfbench import readers


def read(run):
    return readers.mfu_percent(run, "mla_prefill")
