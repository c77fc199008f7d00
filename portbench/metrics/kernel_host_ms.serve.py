"""Host ms of the hand-written kernels' calls in a request (the program's
``kernel.<name>`` spans: checks, operand packing, the custom op's dispatch
and the launch), over the requests of the traced stretch's device-only
pass."""

from portbench.harness import program_spans as ps


def read(record):
    return ps.ms_per_root(record, ps.SERVE_ROOT, ps.kernel)
