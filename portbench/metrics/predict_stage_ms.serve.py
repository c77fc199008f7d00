"""Host ms a request spends validating its arrays and staging them on the
card (the program's ``serve.validate`` and ``serve.stage`` spans: the
pageable copy of the request's arrays and the pad), over the requests of
the traced stretch's device-only pass."""

from portbench.harness import program_spans as ps


def read(record):
    return ps.ms_per_root(record, ps.SERVE_ROOT, ps.named("serve.validate", "serve.stage"))
