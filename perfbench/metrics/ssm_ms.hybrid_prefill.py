"""ssm_ms.hybrid_prefill: device ms of a prefill batch of the Mamba-2
mixers (``models/mamba2.py`` ``apply``: in_proj, the conv, the SSD, the
gated norm, out_proj): the union of the ``ssm`` stage and the
``ssm.scan`` stage inside it."""

from perfbench import stages_hybrid


def read(run):
    return stages_hybrid.union_ms(run, stages_hybrid.SSM)
