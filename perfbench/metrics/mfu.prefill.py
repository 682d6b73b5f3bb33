"""mfu.prefill: the window's model FLOPs (``counts.py``) over its time and
the card's dense bf16 peak (%)."""

from perfbench import readers


def read(run):
    return readers.mfu_percent(run, "prefill")
