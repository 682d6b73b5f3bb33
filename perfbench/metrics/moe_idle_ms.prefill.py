"""moe_idle_ms.prefill: the device's idle ms of a prefill batch while the
host is in a ``moe.*`` stage (route, dispatch, experts, combine)."""

from perfbench import stages


def read(run):
    return stages.moe_idle_ms(run, "prefill")
