"""100 x (1 - device-busy seconds / wall seconds) over the profiled stretch;
busy is the union of the device's event intervals."""

from portbench.harness import stats


def read(record):
    trace = record.get("trace")
    if not trace or not trace["device_events"]:
        return None
    return stats.idle_pct(trace["busy_s"], trace["wall_s"])
