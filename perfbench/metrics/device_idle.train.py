"""device_idle.train: the device's idle share (%) of the traced slice of a
train cell: 1 - the union of device operations / the slice's length."""

from perfbench import readers


def read(run):
    return readers.idle_percent(run, "train")
