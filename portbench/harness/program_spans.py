"""The program's own host spans of a traced run's device-only pass.

The program records a span for each phase of a request (``serve.predict``
and its children), of a train step (``train.step`` and its children) and
for each kernel call (``kernel.<name>``), while a profiler session is
active, into an in-memory buffer (``attention_based_tbn_tpu_torch/utils/
spans.py``). ``harness/trace.profile`` profiles the stretch twice: first
the device's activity alone, then the host's operators too, which slows
the host about twofold. So after a traced run the buffer holds each pass's
roots, and the per-layer readers take the first pass's: the first
``items_traced`` roots by start, with every span of their trees and every
span opened on a thread with none open (autograd's device thread runs the
backward's kernel calls there) that lies inside one of their intervals.

A program without the recorder, or a buffer that does not hold exactly
two passes of roots, gives None: the readers then report nothing rather
than a wrong number.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

SERVE_ROOT = "serve.predict"
TRAIN_ROOT = "train.step"
KERNEL_PREFIX = "kernel."


def program_records() -> Optional[list]:
    """The program's span buffer (None where the program has no recorder)."""
    try:
        from attention_based_tbn_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.snapshot()


def device_pass(records: Sequence, items: int, root_name: str) -> Optional[List]:
    """The spans of the device-only pass: the first ``items`` of the
    ``2 x items`` roots named ``root_name``, their trees, and the parentless
    spans inside their intervals. None on any other count of roots."""
    roots = sorted((s for s in records if s.name == root_name and s.parent is None),
                   key=lambda s: s.start_ns)
    if items <= 0 or len(roots) != 2 * items:
        return None
    chosen = roots[:items]
    ids = {r.id for r in chosen}

    def inside(s) -> bool:
        return any(r.start_ns <= s.start_ns and s.end_ns <= r.end_ns for r in chosen)

    return [s for s in records
            if s.root in ids or (s.parent is None and s.name != root_name and inside(s))]


def record_pass(record: dict, root_name: str) -> Optional[List]:
    """:func:`device_pass` of the program's buffer after a traced run."""
    items = record.get("items_traced")
    records = program_records() if items else None
    if records is None:
        return None
    return device_pass(records, int(items), root_name)


def ms_per_root(record: dict, root_name: str, wanted: Callable[[str], bool]) -> Optional[float]:
    """Host ms of the device-only pass's spans whose name ``wanted`` takes,
    summed, over the pass's roots."""
    picked = record_pass(record, root_name)
    if picked is None:
        return None
    total_ns = sum(s.end_ns - s.start_ns for s in picked if wanted(s.name))
    return total_ns / 1e6 / int(record["items_traced"])


def named(*names: str) -> Callable[[str], bool]:
    return lambda name: name in names


def kernel(name: str) -> bool:
    return name.startswith(KERNEL_PREFIX)
