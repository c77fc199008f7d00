"""The port's host spans (``utils/spans.py``): recorded only while a
``torch.profiler`` session is active, one tree a request or step, on the
profiler's clock. They import no JAX, so the card's check runs on the
card's machine too:

    python -m pytest --noconftest tests/test_torch_port_spans.py -q

On the CPU: a served request (RGB + Audio, 64-px crops, 2 segments, fp32)
splits into its six phases on the profiling thread and on a thread the
profiler does not record; a train step into its five; each span encloses
its profiler event; the recorder follows the profiler's flag. On a card
(``cuda`` marker): one span a kernel launch over a served request.
"""

import threading

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.ops import kernels
from attention_based_tbn_tpu_torch.parallel.train_step import create_train_state, make_train_step
from attention_based_tbn_tpu_torch.tools.serve import ServingModel
from attention_based_tbn_tpu_torch.utils import spans
from attention_based_tbn_tpu_torch.utils.misc import get_modality

OVERRIDES = ["data.audio.audio_length=1.279", "tpu.compute_dtype=float32",
             "data.test_crop_size=64", "data.train_crop_size=64", "test.num_segments=2",
             "data.flow.enable=false", "model.attention.attn_dropout=0",
             "model.fusion_dropout=0"]
PREDICT_PHASES = ["serve.validate", "serve.stage", "serve.lock_wait", "serve.forward",
                  "serve.readback", "serve.trim"]
STEP_PHASES = ["train.to_device", "train.forward", "train.backward", "train.optimizer",
               "train.outputs"]
# the children's durations sum to the root's within this share (what lies
# between them: the lock's release, no_grad, the step count, the ranges)
COVER = 0.05


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture(scope="module")
def served():
    return ServingModel(load_config(overrides=OVERRIDES), device="cpu", batch_buckets=(2,))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(records, root_name):
    """The one root named ``root_name`` and its direct children in order
    of start."""
    roots = [s for s in records if s.name == root_name]
    assert len(roots) == 1, [s.name for s in records]
    root = roots[0]
    children = sorted((s for s in records if s.parent == root.id), key=lambda s: s.start_ns)
    return root, children


def _assert_covers(root, children, names):
    assert [c.name for c in children] == names
    assert root.parent is None and root.root == root.id
    for child in children:
        assert child.root == root.id and child.thread == root.thread
        assert root.start_ns <= child.start_ns <= child.end_ns <= root.end_ns
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns
    total = sum(c.end_ns - c.start_ns for c in children)
    assert abs(total - (root.end_ns - root.start_ns)) <= COVER * (root.end_ns - root.start_ns)


def test_nothing_is_recorded_without_a_profiler(served):
    assert spans.span("a") is spans.span("b")  # the shared no-op context
    served.predict(served.example_batch(1))
    assert spans.snapshot() == []


@pytest.mark.parametrize("thread", ["profiling", "another"])
def test_predict_splits_into_its_six_phases(served, thread):
    """Also on a thread started inside the profile, whose operators the
    profiler does not record: the buffer holds every thread's spans."""
    batch = served.example_batch(1, seed=3)
    with _cpu_profile():
        if thread == "profiling":
            served.predict(batch)
        else:
            worker = threading.Thread(target=served.predict, args=(batch,))
            worker.start()
            worker.join(timeout=60)
            assert not worker.is_alive()
    root, children = _tree(spans.snapshot(), "serve.predict")
    _assert_covers(root, children, PREDICT_PHASES)
    assert (root.thread == threading.get_ident()) == (thread == "profiling")


def test_spans_enclose_their_profiler_events(served):
    """The span's clock is the profiler's: on the profiling thread each
    span's interval holds its record_function event's."""
    with _cpu_profile() as prof:
        served.predict(served.example_batch(2, seed=4))
    events = {}
    for event in prof.profiler.kineto_results.events():
        if event.name().startswith("serve."):
            events.setdefault(event.name(), []).append(event)
    recorded = spans.snapshot()
    assert sorted(events) == sorted(s.name for s in recorded)
    for s in recorded:
        (event,) = events[s.name]
        assert s.start_ns <= event.start_ns() <= event.end_ns() <= s.end_ns, s.name


def test_train_step_splits_into_its_five_phases(served):
    cfg = load_config(overrides=OVERRIDES)
    model = build_model(cfg, get_modality(cfg), device="cpu")
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    rng = np.random.default_rng(5)
    targets = {"class": {"verb": rng.integers(0, 125, 2).astype(np.int64),
                         "noun": rng.integers(0, 352, 2).astype(np.int64)}}
    with _cpu_profile():
        step(state, served.example_batch(2, seed=5), targets, 0, 2)
    root, children = _tree(spans.snapshot(), "train.step")
    _assert_covers(root, children, STEP_PHASES)


def test_recorder_follows_the_profiler_flag():
    """Pins torch's private process-wide flag, which the recorder reads: a
    torch release that moves it fails here."""
    assert autograd_profiler._is_profiler_enabled is False
    with _cpu_profile():
        assert autograd_profiler._is_profiler_enabled is True
        with spans.span("inside"):
            pass
    assert autograd_profiler._is_profiler_enabled is False
    with spans.span("after"):
        pass
    assert [s.name for s in spans.snapshot()] == ["inside"]


def test_a_span_that_raises_is_recorded_and_closed():
    with _cpu_profile():
        with pytest.raises(ValueError):
            with spans.span("outer"):
                with spans.span("failing"):
                    raise ValueError("x")
        with spans.span("next"):
            pass
    by_name = {s.name: s for s in spans.snapshot()}
    assert by_name["failing"].parent == by_name["outer"].id
    assert by_name["next"].parent is None and by_name["next"].root == by_name["next"].id


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
def test_one_kernel_span_a_launch_over_a_served_request(card):
    """The flagship's serving path at one clip (bf16, 224^2, every serving
    kernel on): each ``kernel.<name>`` span count equals the launches of
    ``kernels.WRAPPERS[name]`` in the same request."""
    cfg = load_config(overrides=["tpu.fused_stem=true", "tpu.fast_consensus=true",
                                 "tpu.pool_impl=pallas", "model.pretrained=false"])
    model = ServingModel(cfg, device="cuda", batch_buckets=(1,))
    batch = model.example_batch(1, seed=6)
    model.predict(batch)  # builds the kernels
    before = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}
    with profile(activities=[ProfilerActivity.CUDA]):
        model.predict(batch)
    launched = {name: fn.launches - before[name] for name, fn in kernels.WRAPPERS.items()}
    counted = {name: sum(s.name == f"kernel.{name}" for s in spans.snapshot())
               for name in kernels.WRAPPERS}
    assert counted == launched
    assert all(launched[k] for k in ("pe_block", "mha", "max_pool", "fused_stem",
                                     "consensus_heads"))
