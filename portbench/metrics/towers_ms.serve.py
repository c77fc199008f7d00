"""Device milliseconds between each tower's entry and exit, summed over
the towers, per request of the window (CUDA events of the benchmark's
forward hooks)."""


def read(record):
    spans = record.get("spans")
    if not spans or not spans["requests"]:
        return None
    return spans["towers_ms"] / spans["requests"]
