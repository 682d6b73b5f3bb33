"""optimizer_ms.train: device ms of a train step in the ``train.optimizer``
stage (``train/step.py`` around ``adamw.update``)."""

from perfbench import stages


def read(run):
    return stages.stage_ms(run, "train", "train.optimizer")
