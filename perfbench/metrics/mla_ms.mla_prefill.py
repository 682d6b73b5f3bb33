"""mla_ms.mla_prefill: device ms of a prefill batch of the latent
attention (``models/mla.py``: its five projections, norms and rotations,
and the attention core): the union of the ``mla`` stage and the
``mla.attend`` stage inside it."""

from perfbench import stages_mla


def read(run):
    return stages_mla.union_ms(run, stages_mla.MLA)
