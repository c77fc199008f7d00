"""Host ms of a train step's backward call (the program's
``train.backward`` span), over the steps of the traced stretch's
device-only pass."""

from portbench.harness import program_spans as ps


def read(record):
    return ps.ms_per_root(record, ps.TRAIN_ROOT, ps.named("train.backward"))
