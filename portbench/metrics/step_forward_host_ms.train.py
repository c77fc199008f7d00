"""Host ms of a train step's forward and loss (the program's
``train.forward`` span), over the steps of the traced stretch's
device-only pass."""

from portbench.harness import program_spans as ps


def read(record):
    return ps.ms_per_root(record, ps.TRAIN_ROOT, ps.named("train.forward"))
