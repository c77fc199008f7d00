"""A short profiled stretch of steady work, reduced to what the per-layer
metrics and the breakdown read.

``torch.profiler`` records the device's kernels and copies (CUPTI) and the
host's operators. The stretch is kept short so the trace stays small; it
is reduced in memory and never written to disk.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Sequence

from . import device as dev, stats

TOP = 10  # entries of each breakdown list
GAPS_NAMED = 400  # longest idle gaps named by the host's work
# the host ranges the drivers label (torch.profiler.record_function)
LABELS = ("client: predict", "train: step call", "train: synchronize")


def _device_events(prof) -> List[tuple]:
    """The device's kernels, copies and sets: not the device-side copies of
    the host's labelled ranges (``record_function``), which span them."""
    from torch.autograd import DeviceType

    labels = {e.name for e in prof.events() if e.device_type == DeviceType.CPU
              and getattr(e, "is_user_annotation", False)} | set(LABELS)
    out = []
    for event in prof.events():
        if (event.device_type == DeviceType.CUDA and event.name not in labels
                and not getattr(event, "is_user_annotation", False)):
            out.append((event.name, event.time_range.start / 1e6, event.time_range.end / 1e6))
    return out


def _host_events(prof) -> List[tuple]:
    from torch.autograd import DeviceType

    return sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CPU)


def _name_gaps(gaps: List[tuple], host: List[tuple]) -> Dict[str, float]:
    """{host activity: idle seconds}: each gap named by the innermost host
    event that covers its middle (the latest-starting one that has not
    ended), or "host outside any operator"."""
    starts = [h[0] for h in host]
    named: Dict[str, float] = {}
    for start, end in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
        mid = 0.5 * (start + end)
        name = "host outside any operator"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            if host[i][1] >= mid:
                name = host[i][2]
                break
            i -= 1
        named[name] = named.get(name, 0.0) + (end - start)
    return named


def _stretch(work: Callable[[], None], device, activities) -> tuple:
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=activities) as prof:
        began = time.perf_counter()
        work()
        dev.sync(device)
        wall = time.perf_counter() - began
    return prof, wall


def profile(work: Callable[[], None], device="cuda") -> dict:
    """Run ``work`` (a fixed stretch of steady work) twice under the
    profiler. First with the device's activity alone, which costs the host
    little: the stretch's wall seconds, the device's busy seconds (the
    union of its event intervals), device seconds per event name and the
    host-to-device copy seconds. Then with the host's operators too, which
    slows the host about twofold: the longest idle gaps named by what the
    host was doing. Returns those and the breakdown lists."""
    from torch.profiler import ProfilerActivity

    device_only = [ProfilerActivity.CUDA] if dev.is_cuda(device) else [ProfilerActivity.CPU]
    lean, wall = _stretch(work, device, device_only)
    events = _device_events(lean)
    per_name: Dict[str, float] = {}
    for name, start, end in events:
        per_name[name] = per_name.get(name, 0.0) + (end - start)
    busy = stats.busy((start, end) for _, start, end in events)
    detailed, _ = _stretch(work, device, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    intervals = stats.merged((start, end) for _, start, end in _device_events(detailed))
    gaps = [(a[1], b[0]) for a, b in zip(intervals, intervals[1:]) if b[0] > a[1]]
    named = _name_gaps(gaps, _host_events(detailed)) if gaps else {}
    top_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "wall_s": wall,
        "busy_s": busy,
        "device_events": len(events),
        "per_name_s": per_name,
        "htod_s": sum(s for n, s in per_name.items() if "HtoD" in n),
        "breakdown": {"device_ops": [[n[:160], s] for n, s in top_ops],
                      "idle_gaps": [[n[:160], s] for n, s in top_gaps]},
    }


def kernel_seconds(per_name_s: Dict[str, float], needles: Sequence[str]) -> float:
    """Device seconds of the events whose name holds any of ``needles``."""
    return sum(s for name, s in per_name_s.items() if any(k in name for k in needles))
