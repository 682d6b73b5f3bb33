"""ssm_idle_ms.hybrid_prefill: the device's idle ms of a prefill batch
while the host is in a Mamba-2 mixer (``ssm``, ``ssm.scan``), which holds
the host's loop over the chunks."""

from perfbench import stages_hybrid


def read(run):
    return stages_hybrid.idle_ms(run, stages_hybrid.SSM)
