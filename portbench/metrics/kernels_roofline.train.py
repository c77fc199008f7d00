"""The least time the card could take for the work of the hand-written
kernels a training step runs (costs/kernels.py, at the step's shapes)
over the device time of those kernels in the profiled stretch, in %."""

from portbench.costs.kernels import KERNEL_NAMES
from portbench.harness import stats
from portbench.harness.trace import kernel_seconds


def read(record):
    trace, work = record.get("trace"), record.get("work_least_s")
    if not trace or not work:
        return None
    least = device = 0.0
    for kernel, seconds in work.items():
        spent = kernel_seconds(trace["per_name_s"], KERNEL_NAMES[kernel])
        if spent > 0:  # a kernel not seen in the trace is left out, work and time
            least += seconds * record["items_traced"]
            device += spent
    return stats.roofline_pct(least, device) if device else None
