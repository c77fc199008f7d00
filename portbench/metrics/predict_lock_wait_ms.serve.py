"""Host ms a request waits for the device lock (the program's
``serve.lock_wait`` span: mostly the other client's forward and readback),
over the requests of the traced stretch's device-only pass."""

from portbench.harness import program_spans as ps


def read(record):
    return ps.ms_per_root(record, ps.SERVE_ROOT, ps.named("serve.lock_wait"))
