"""Clips trained in the window, over its seconds; every
step ended by a synchronize."""

from portbench.harness import stats


def read(record):
    return stats.rate(record["clips"], record["window_s"])
