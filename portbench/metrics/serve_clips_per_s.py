"""Clips of the requests completed inside the window, over its seconds."""

from portbench.harness import stats


def read(record):
    return stats.rate(record["clips"], record["window_s"])
