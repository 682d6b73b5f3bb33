"""mfu.hybrid_prefill: the window's model FLOPs (``counts_hybrid.py``) over
its time and the card's dense bf16 peak (%)."""

from perfbench import readers


def read(run):
    return readers.mfu_percent(run, "hybrid_prefill")
