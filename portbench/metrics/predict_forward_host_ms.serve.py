"""Host ms of a request's forward call, to its return (the program's
``serve.forward`` span: the towers', fusion's and heads' dispatch, which
may wait on the device), over the requests of the traced stretch's
device-only pass."""

from portbench.harness import program_spans as ps


def read(record):
    return ps.ms_per_root(record, ps.SERVE_ROOT, ps.named("serve.forward"))
