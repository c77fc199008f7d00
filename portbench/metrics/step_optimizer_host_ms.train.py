"""Host ms of a train step's optimizer call: the clip, the gradients'
all-reduce where there are ranks, the update (the program's
``train.optimizer`` span), over the steps of the traced stretch's
device-only pass."""

from portbench.harness import program_spans as ps


def read(record):
    return ps.ms_per_root(record, ps.TRAIN_ROOT, ps.named("train.optimizer"))
