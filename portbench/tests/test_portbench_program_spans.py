"""The readers of the program's spans on synthetic buffers: the device-only
pass is the first half of the roots, a wrong count of roots reads
nothing, a kernel span on a thread with no span open counts by time, and
a program without the recorder reads nothing."""

from __future__ import annotations

import os
from collections import namedtuple

import pytest

from portbench.harness import program_spans as ps
from portbench.harness.catalog import Catalog

Span = namedtuple("Span", "name id parent root thread start_ns end_ns")
MS = 1_000_000


class Buffer:
    """Spans of synthetic requests or steps, times in ms."""

    def __init__(self):
        self.spans, self._next = [], 1

    def add(self, name, start, end, parent=None, thread=1):
        sid = self._next
        self._next += 1
        root = sid if parent is None else parent.root
        s = Span(name, sid, None if parent is None else parent.id, root, thread,
                 int(start * MS), int(end * MS))
        self.spans.append(s)
        return s

    def request(self, start, thread, phases=(("serve.validate", 1), ("serve.stage", 4),
                                            ("serve.lock_wait", 10), ("serve.forward", 20),
                                            ("serve.readback", 5), ("serve.trim", 0))):
        total = sum(ms for _, ms in phases)
        root = self.add(ps.SERVE_ROOT, start, start + total, thread=thread)
        t = start
        for name, ms in phases:
            child = self.add(name, t, t + ms, root, thread)
            if name == "serve.forward":
                self.add("kernel.mha", t + 1, t + 1.5, child, thread)
            t += ms
        return root


@pytest.fixture
def readers():
    catalog = Catalog()
    folder = os.path.join(catalog.bench, "metrics")
    return {f[:-3]: catalog.reader(f[:-3]) for f in os.listdir(folder) if f.endswith(".py")}


def _serve_buffer():
    """Two passes of two clients' overlapping requests; the second pass's
    phases twice as long (the host slowed by the profiler)."""
    buf = Buffer()
    buf.request(0, thread=1)
    buf.request(5, thread=2)
    slow = (("serve.validate", 2), ("serve.stage", 8), ("serve.lock_wait", 20),
            ("serve.forward", 40), ("serve.readback", 10), ("serve.trim", 0))
    buf.request(100, thread=1, phases=slow)
    buf.request(105, thread=2, phases=slow)
    return buf


def test_the_first_pass_is_the_first_half_of_the_roots():
    buf = _serve_buffer()
    picked = ps.device_pass(buf.spans, 2, ps.SERVE_ROOT)
    assert len(picked) == 2 * 8
    assert max(s.end_ns for s in picked) == 45 * MS


@pytest.mark.parametrize("items", [0, 1, 3])
def test_another_count_of_roots_reads_nothing(items):
    assert ps.device_pass(_serve_buffer().spans, items, ps.SERVE_ROOT) is None
    assert ps.device_pass([], 2, ps.SERVE_ROOT) is None


def test_serving_readers(readers, monkeypatch):
    buf = _serve_buffer()
    monkeypatch.setattr(ps, "program_records", lambda: buf.spans)
    record = {"items_traced": 2}
    assert readers["predict_stage_ms.serve"].read(record) == pytest.approx(5.0)
    assert readers["predict_lock_wait_ms.serve"].read(record) == pytest.approx(10.0)
    assert readers["predict_forward_host_ms.serve"].read(record) == pytest.approx(20.0)
    assert readers["predict_readback_ms.serve"].read(record) == pytest.approx(5.0)
    assert readers["kernel_host_ms.serve"].read(record) == pytest.approx(0.5)
    assert readers["predict_stage_ms.serve"].read({}) is None  # untraced


def test_kernel_spans_on_a_thread_with_none_open_count_by_time(readers, monkeypatch):
    buf = Buffer()
    for start, scale in ((0, 1), (100, 2)):
        step = buf.add(ps.TRAIN_ROOT, start, start + 30 * scale)
        buf.add("train.forward", start, start + 10 * scale, step)
        buf.add("kernel.max_pool", start + 1, start + 2, step)
        backward = buf.add("train.backward", start + 10 * scale, start + 25 * scale, step)
        # autograd's device thread: no span open there, so no parent
        buf.add("kernel.max_pool_backward", start + 11 * scale, start + 14 * scale, thread=9)
        buf.add("train.optimizer", start + 25 * scale, start + 29 * scale, step)
        assert backward.root == step.id
    buf.add("kernel.max_pool_backward", 50, 51, thread=9)  # between the passes
    monkeypatch.setattr(ps, "program_records", lambda: buf.spans)
    record = {"items_traced": 1}
    assert readers["step_forward_host_ms.train"].read(record) == pytest.approx(10.0)
    assert readers["step_backward_host_ms.train"].read(record) == pytest.approx(15.0)
    assert readers["step_optimizer_host_ms.train"].read(record) == pytest.approx(4.0)
    assert readers["kernel_host_ms.train"].read(record) == pytest.approx(1.0 + 3.0)


def test_a_program_without_the_recorder_reads_nothing(readers, monkeypatch):
    monkeypatch.setattr(ps, "program_records", lambda: None)
    for name in ("predict_stage_ms.serve", "kernel_host_ms.serve", "step_forward_host_ms.train",
                 "kernel_host_ms.train"):
        assert readers[name].read({"items_traced": 3}) is None


def test_the_program_buffer_is_read():
    from attention_based_tbn_tpu_torch.utils import spans

    spans.clear()
    assert ps.program_records() == []
