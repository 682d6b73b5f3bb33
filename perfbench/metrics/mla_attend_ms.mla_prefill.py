"""mla_attend_ms.mla_prefill: device ms of a prefill batch of latent
attention's core, the ``mla.attend`` stage (K8 at q·k 192 and v 128)."""

from perfbench import stages_mla


def read(run):
    return stages_mla.union_ms(run, ("mla.attend",))
