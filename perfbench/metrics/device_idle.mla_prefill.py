"""device_idle.mla_prefill: the device's idle share (%) of the traced
slice of a latent-attention prefill cell: 1 - the union of device
operations / the slice's length."""

from perfbench import readers


def read(run):
    return readers.idle_percent(run, "mla_prefill")
