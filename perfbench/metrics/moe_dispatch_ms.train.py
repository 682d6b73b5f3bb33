"""moe_dispatch_ms.train: device ms of a train step of the MoE's
``moe.dispatch`` stage (the sort, ``x[order // k]``, K7, positions and
slots, ``index_put_`` into the buffer), forward, recompute and backward."""

from perfbench import stages


def read(run):
    return stages.stage_ms(run, "train", "moe.dispatch")
