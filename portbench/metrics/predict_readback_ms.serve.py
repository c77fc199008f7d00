"""Host ms of a request's readback (the program's ``serve.readback`` span:
the outputs to float32 numpy, which waits for the device to finish), over
the requests of the traced stretch's device-only pass."""

from portbench.harness import program_spans as ps


def read(record):
    return ps.ms_per_root(record, ps.SERVE_ROOT, ps.named("serve.readback"))
