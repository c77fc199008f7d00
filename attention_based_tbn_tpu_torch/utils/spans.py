"""Named host spans of a request, a train step and each kernel call,
recorded while a ``torch.profiler`` session is active in the process.

``with span("serve.forward"): ...`` marks a stretch of host work. With no
profiler session active it costs one check of the profiler's process-wide
flag and returns a shared context that does nothing. During a session it
reads the host clock, enters ``torch.profiler.record_function(name)``,
runs the body, exits the range, reads the clock again and appends a
:class:`Span` to a bounded in-memory buffer (the oldest records go first
once it holds :data:`CAPACITY`).

* A span's ``parent`` is the innermost span open on the same thread when it
  began; ``root`` is the outermost one's id, shared by every span of one
  request or step. A span opened on a thread with none open (autograd's
  device thread runs the backward's kernel calls there) is a root of its
  own, so a reader attributes such spans by time, not by parent. A span
  opened before the session began is not recorded, and spans opened inside
  it then record as roots.
* The clock is ``time.time_ns()``: Unix-epoch nanoseconds, the clock the
  profiler's host events are reported on, so the buffer's spans lie on a
  trace's timeline as they are. The profiler records host operators only
  on the thread that started it; the buffer holds every thread's spans, so
  a request served on another thread is still split into its phases.
* The same ranges appear in the profiler's own trace on the threads it
  records (an operator's ``tpu.profile_steps`` trace of training, for one),
  where they name the host's work in the device's idle gaps.

:func:`snapshot` returns the records (the buffer keeps them) and
:func:`clear` empties the buffer.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

CAPACITY = 65536  # records the buffer keeps


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]  # the innermost span open on the thread, or None
    root: int  # the outermost span's id (its own for a root)
    thread: int  # threading.get_ident() of the thread that ran it
    start_ns: int  # time.time_ns() before the profiler range was entered
    end_ns: int  # time.time_ns() after it was exited


_records: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()


_OFF = contextlib.nullcontext()  # the shared context of a span with no session active


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Recording:
    __slots__ = ("name", "id", "parent", "root", "start_ns", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open_spans()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.root = outer.root if outer else self.id
        stack.append(self)
        self.start_ns = time.time_ns()
        self._range = _profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        try:
            self._range.__exit__(*exc)
        finally:
            end_ns = time.time_ns()
            _open_spans().pop()
            _records.append(Span(self.name, self.id, self.parent, self.root,
                                 threading.get_ident(), self.start_ns, end_ns))
        return False


def span(name: str):
    """A context that records ``name`` while a profiler session is active,
    and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name)


def snapshot() -> List[Span]:
    """The buffer's records, oldest first; the buffer keeps them."""
    return list(_records)


def clear() -> None:
    _records.clear()
