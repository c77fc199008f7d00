"""The port's visualizer (tools/vis.py) against the JAX package's
``tools/vis.py`` on the same synthetic fixture and the same weights (carried
by models/bridge.py, or by one reference ``.pth`` both import): the
``get_info`` table, the arrays ``visualize`` draws, the PNG, the clip, and
the ``config_vis`` entry point with a checkpoint. fp32
on the CPU; 64-px crops, 2 segments, 7 verbs / 9 nouns."""

import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.config import load_config as jax_load_config
from attention_based_tbn_tpu.data.classes import EpicClasses as JaxEpicClasses
from attention_based_tbn_tpu.models.builder import build_model as jax_build_model
from attention_based_tbn_tpu.parallel.train_step import TrainState as JaxTrainState
from attention_based_tbn_tpu.tools import vis as jax_vis
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.data import synthetic
from attention_based_tbn_tpu_torch.data.classes import EpicClasses
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.models.convert_back import save_reference_checkpoint
from attention_based_tbn_tpu_torch.tools import vis

from torch_port_helpers import one_torch_thread, port_model  # noqa: F401

VERBS, NOUNS = 7, 9


def _write_class_tables(root):
    """EPIC_verb_classes.csv / EPIC_noun_classes.csv naming class i
    ``verb<i>`` / ``noun<i>``, so an action list resolves names to ids."""
    ann = os.path.join(root, "annotations")
    for kind, n in (("verb", VERBS), ("noun", NOUNS)):
        with open(os.path.join(ann, f"EPIC_{kind}_classes.csv"), "w", newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow([f"{kind}_id", "class_key", f"{kind}s"])
            writer.writerows([i, f"{kind}{i}", f"['{kind}{i}']"] for i in range(n))


def _overrides(root):
    return [
        f"data_dir={root}", f"out_dir={root}", "data.flow.enable=False",
        "data.audio.read_audio_pickle=False", "data.audio.audio_length=1.279",
        "data.test_scale_size=80", "data.test_crop_size=64",
        f"model.num_classes={{verb: {VERBS}, noun: {NOUNS}}}", "model.pretrained=False",
        "test.num_segments=2", "num_workers=1", "val.vid_list=",
        "tpu.compute_dtype=float32", "tpu.platform=cpu",
    ]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_vis"))
    synthetic.generate(root, videos=["P01_01"], frames_per_video=60, num_verbs=VERBS,
                       num_nouns=NOUNS)
    _write_class_tables(root)
    over = _overrides(root)
    cfg = load_config(overrides=over, config_name="config_vis")
    jcfg = jax_load_config(overrides=over, config_name="config_vis")
    modality = ["RGB", "Audio"]
    model = port_model(cfg)
    jmodel, _ = jax_build_model(jcfg, modality)
    variables = state_dict_to_jax(model.state_dict())
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree.map(jnp.asarray, variables["params"]),
                           batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                           opt_state=())
    return {"root": root, "cfg": cfg, "jcfg": jcfg, "modality": modality, "model": model,
            "jmodel": jmodel, "jstate": jstate,
            "dataset": vis.create_dataset(cfg, modality),
            "jdataset": jax_vis.create_dataset(jcfg, modality)}


def _assert_rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key == "attn_entropy":
                assert abs(g[key] - w[key]) <= 1e-5, (g[key], w[key])
            else:
                assert g[key] == w[key], key


def test_get_info_matches_jax(setup):
    """Rows: equal uid, video, predicted and true classes and class names;
    the reference's entropy within 1e-5 (fp32)."""
    s = setup
    ann = os.path.join(s["root"], "annotations")
    got = vis.get_info(s["cfg"], s["model"], None, s["dataset"], max_samples=3,
                       epic_classes=EpicClasses(ann))
    want = jax_vis.get_info(s["jcfg"], s["jmodel"], s["jstate"], s["jdataset"], max_samples=3,
                            epic_classes=JaxEpicClasses(ann))
    assert len(got) == 3 and "attn_entropy" in got[0] and "pred_verb_name" in got[0]
    _assert_rows_match(got, want)


def test_sweep_returns_get_info_rows_and_their_scores(setup):
    """sweep(): get_info's rows, and each head's (n, classes) scores of the
    same forwards, whose argmax is the row's prediction and whose top 5
    equal panels()' for that sample."""
    s = setup
    rows, scores = vis.sweep(s["cfg"], s["model"], None, s["dataset"], max_samples=3)
    _assert_rows_match(rows, vis.get_info(s["cfg"], s["model"], None, s["dataset"],
                                          max_samples=3))
    assert scores["verb"].shape == (3, VERBS) and scores["noun"].shape == (3, NOUNS)
    for index, row in enumerate(rows):
        top5 = vis.panels(s["cfg"], s["model"], None, s["dataset"], index)["top5"]
        for key in ("verb", "noun"):
            assert int(scores[key][index].argmax()) == row[f"pred_{key}"]
            ids, values = top5[key]
            np.testing.assert_array_equal(scores[key][index][ids], values)


def _pairs(root):
    """The fixture's (verb, noun) name pairs, in order of first use."""
    with open(os.path.join(root, "annotations", "epic_train_val.csv"), newline="") as fh:
        pairs = []
        for row in csv.DictReader(fh):
            pair = (f"verb{row['verb_class']}", f"noun{row['noun_class']}")
            if pair not in pairs:
                pairs.append(pair)
    return pairs


def test_create_dataset_filters_actions_as_jax(setup):
    """Two (verb, noun) pairs of the fixture keep the same clips."""
    s = setup
    pairs = _pairs(s["root"])
    got = vis.create_dataset(s["cfg"], s["modality"], action_list=pairs[:2])
    want = jax_vis.create_dataset(s["jcfg"], s["modality"], action_list=pairs[:2])
    assert 0 < len(got) < len(s["dataset"])
    assert [got.record(i).uid for i in range(len(got))] == \
        [want.record(i).uid for i in range(len(want))]


class _Recorder:
    """Records the arrays JAX's ``visualize`` hands matplotlib."""

    def __init__(self, monkeypatch):
        from matplotlib.axes import Axes

        self.calls = {"imshow": [], "plot": [], "bar": []}
        for name in self.calls:
            real = getattr(Axes, name)

            def spy(ax, *args, _name=name, _real=real, **kw):
                self.calls[_name].append(args)
                return _real(ax, *args, **kw)

            monkeypatch.setattr(Axes, name, spy)


def test_panels_match_the_arrays_jax_visualize_draws(setup, monkeypatch, tmp_path):
    """panels() against what JAX's visualize draws for the same sample:
    the RGB frames exactly, the spectrograms within 1e-4 (log power), the
    attention curves within 1e-5, the top-5 class ids equal and their
    scores within 1e-4."""
    s = setup
    grid = vis.panels(s["cfg"], s["model"], None, s["dataset"], 1)
    recorder = _Recorder(monkeypatch)
    jax_vis.visualize(s["jcfg"], s["jmodel"], s["jstate"], s["jdataset"], 1,
                      out_path=str(tmp_path / "jax.png"))
    calls = recorder.calls
    n_seg = int(s["cfg"].test.num_segments)
    frames = np.stack([np.asarray(c[0]) for c in calls["imshow"][:n_seg]])
    specs = np.stack([np.asarray(c[0]) for c in calls["imshow"][n_seg:]])
    curves = np.stack([np.asarray(c[0], np.float32) for c in calls["plot"]])
    assert grid["rgb"].shape == frames.shape and np.array_equal(grid["rgb"], frames)
    assert grid["spectrograms"].shape == specs.shape
    np.testing.assert_allclose(grid["spectrograms"], specs, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(grid["weights"], curves, rtol=1e-5, atol=1e-5)
    assert list(grid["top5"]) == ["verb", "noun"] and len(calls["bar"]) == 2
    for (top, scores), (labels, heights) in zip(grid["top5"].values(), calls["bar"]):
        assert [str(i) for i in top] == list(labels)
        np.testing.assert_allclose(scores, np.asarray(heights, np.float32), rtol=1e-4,
                                   atol=1e-4)
    assert grid["meta"]["vid_id"] == "P01_01"


def test_visualize_writes_a_png_and_the_clip(setup, tmp_path):
    s = setup
    out = vis.visualize(s["cfg"], s["model"], None, s["dataset"], 0,
                        out_path=str(tmp_path / "vis.png"), save_clip=True)
    assert os.path.getsize(out) > 1000
    with open(out, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
    assert any(name.startswith("temp.") for name in os.listdir(tmp_path))


def test_save_action_segment_from_frames_matches_jax(setup, tmp_path):
    """The clip from the frame directory: the same file as JAX's writer
    gives (both through cv2), of the same frames."""
    import cv2

    s = setup
    fps = float(s["cfg"].data.vid_fps)
    got = vis.save_action_segment(s["root"], "P01_01", 0.1, 0.5,
                                  out_path=str(tmp_path / "port" / "clip.MP4"), fps=fps)
    want = jax_vis.save_action_segment(s["root"], "P01_01", 0.1, 0.5,
                                       out_path=str(tmp_path / "jax" / "clip.MP4"), fps=fps)
    assert os.path.basename(got) == os.path.basename(want)

    def frames(path):
        cap = cv2.VideoCapture(path)
        out = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            out.append(frame)
        cap.release()
        return out

    got_frames, want_frames = frames(got), frames(want)
    assert len(got_frames) == len(want_frames) == int(0.5 * fps) - int(0.1 * fps) + 1
    assert all(np.array_equal(a, b) for a, b in zip(got_frames, want_frames))


def test_initialize_from_config_vis_and_a_reference_pth(setup, tmp_path):
    """initialize() composes config_vis (3 segments, batch 1, mha) with the
    overrides, builds the model on tpu.platform's device and loads a
    reference .pth (models/convert_back); the JAX package's initialize
    reads the same file, and both tables agree."""
    s = setup
    path = str(tmp_path / "ref.pth")
    save_reference_checkpoint(path, s["model"], s["model"].spec)
    over = _overrides(s["root"]) + ["test.num_segments=3"]
    cfg, model, modality, state = vis.initialize(over, path)
    assert cfg.test.batch_size == 1 and cfg.model.attention.type == "mha"
    assert modality == ["RGB", "Audio"] and state is not None and state.model is model
    assert next(model.parameters()).device.type == "cpu"
    own = s["model"].state_dict()
    assert all(torch.equal(v, own[k]) for k, v in model.state_dict().items())
    jcfg, jmodel, _, jstate = jax_vis.initialize(over, path)
    got = vis.get_info(cfg, model, state, vis.create_dataset(cfg, modality), max_samples=1)
    want = jax_vis.get_info(jcfg, jmodel, jstate, jax_vis.create_dataset(jcfg, modality),
                            max_samples=1)
    _assert_rows_match(got, want)
    assert vis.initialize(["tpu.platform=cpu", "data.flow.enable=False"])[3] is None


def test_initialize_runs_on_cuda_unless_the_config_says_cpu():
    """No tpu.platform: the model is built for the card, which this host
    lacks, so initialize raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        vis.initialize(["data.flow.enable=False"])
