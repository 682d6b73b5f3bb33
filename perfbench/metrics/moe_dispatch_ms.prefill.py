"""moe_dispatch_ms.prefill: device ms of a prefill batch of the MoE's
``moe.dispatch`` stage (the sort, ``x[order // k]``, K7, positions and
slots, ``index_put_`` into the buffer): the forward alone."""

from perfbench import stages


def read(run):
    return stages.stage_ms(run, "prefill", "moe.dispatch")
