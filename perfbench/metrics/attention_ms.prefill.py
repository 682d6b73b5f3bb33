"""attention_ms.prefill: device ms of a prefill batch of the program's
``attention`` stage (``models/attention.py`` ``attend``: the
projections, RoPE, the core and the output projection): the forward
alone."""

from perfbench import stages


def read(run):
    return stages.stage_ms(run, "prefill", "attention")
