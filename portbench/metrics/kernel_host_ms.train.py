"""Host ms of the hand-written kernels' calls in a train step, forward and
backward (the program's ``kernel.<name>`` spans on any thread inside the
step), over the steps of the traced stretch's device-only pass."""

from portbench.harness import program_spans as ps


def read(record):
    return ps.ms_per_root(record, ps.TRAIN_ROOT, ps.kernel)
