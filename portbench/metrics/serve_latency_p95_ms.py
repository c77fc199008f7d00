"""95th percentile (nearest rank) of the latency of every request completed
inside the window, from the client's call of predict to its return."""

from portbench.harness import stats


def read(record):
    return 1e3 * stats.percentile(record["latencies_s"], 95)
