"""moe_idle_ms.train: the device's idle ms of a train step while the host
is in a ``moe.*`` stage (route, dispatch, experts, combine)."""

from perfbench import stages


def read(run):
    return stages.moe_idle_ms(run, "train")
