"""Host milliseconds inside the step call, from the call to its return and
before the synchronize, per step of the window: the step's dispatch cost."""


def read(record):
    host = record.get("step_host_s")
    if not host or "trace" not in record:
        return None
    return 1e3 * sum(host) / len(host)
