"""Resume of the port's ``run_trainer`` (RGB + Audio with MHA attention and
Fusion, 64-px crops, 2 segments, float32, the default dropout 0.5, so the
dropout generator's state matters): 1 epoch and a resume of 1 from the
``.pth`` it wrote equal 2 uninterrupted epochs bit for bit on the CPU
(weights, optimizer state, generator state, step, history); ``_best`` is
written, and a resume re-seeds its threshold from the restored history
(the JAX package's tools/train.py:320-331); ``tpu.steps_per_call`` is a
warned no-op."""

import json
import logging
import os

import pytest
import torch

from attention_based_tbn_tpu.data import synthetic
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.tools.train import checkpoint_stem, run_trainer
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

VIDEOS = ["P01_01", "P02_03"]
MODALITY = ["RGB", "Audio"]


def _overrides(root, exp, *extra):
    split = os.path.join(root, "train_split.txt")
    return [
        f"data_dir={root}", f"out_dir={root}/out", f"exp_name={exp}", "num_workers=2",
        "data.flow.enable=false", "data.audio.audio_length=1.279",
        "data.train_scale_size=72", "data.train_crop_size=64", "data.test_scale_size=72",
        "data.test_crop_size=64", "model.num_classes={verb: 7, noun: 9}",
        "model.pretrained=false", "tpu.compute_dtype=float32", f"train.vid_list={split}",
        "train.batch_size=3", "train.epochs=2", "train.num_segments=2",
        f"val.vid_list={split}", "val.batch_size=6", "val.num_segments=2",
        "train.save_best=true", *extra,
    ]


def _history(stem):
    with open(stem + ".history.json") as fh:
        return json.load(fh)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_resume"))
    synthetic.generate(root, videos=VIDEOS, frames_per_video=60, actions_per_video=3,
                       image_hw=(72, 96), num_verbs=7, num_nouns=9)
    return root


@pytest.fixture(scope="module")
def resumed(root):
    """2 epochs straight; 1 epoch, then a resume of 1."""
    torch.set_num_threads(1)
    logger = logging.getLogger("port_resume")
    straight = load_config(overrides=_overrides(root, "straight"))
    run_trainer(straight, logger, MODALITY, device="cpu")
    first = load_config(overrides=_overrides(root, "resumed", "train.epochs=1"))
    run_trainer(first, logger, MODALITY, device="cpu")
    stem = checkpoint_stem(first, MODALITY)
    after_one = _load(stem + ".pth")
    again = load_config(overrides=_overrides(root, "resumed", "train.epochs=1",
                                             f"train.pre_trained={stem}.pth"))
    run_trainer(again, logger, MODALITY, device="cpu")
    return checkpoint_stem(straight, MODALITY), stem, after_one


def _assert_equal(got, want, path="checkpoint"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_equal(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), path
    else:
        assert got == want, path


def test_resume_equals_an_uninterrupted_run(resumed):
    straight, stem, after_one = resumed
    got, want = _load(stem + ".pth"), _load(straight + ".pth")
    assert after_one["epoch"] == 0 and got["epoch"] == 1
    assert not torch.equal(got["generator"], after_one["generator"])  # dropout drew noise
    _assert_equal(got, want)
    assert _history(stem) == _history(straight)


def test_best_is_written_and_its_threshold_survives_a_resume(root, resumed, caplog):
    _, stem, after_one = resumed
    assert _load(stem + "_best.pth")["epoch"] in (0, 1)
    # a restored history whose best no epoch can beat: no _best is written
    doctored = dict(after_one)
    doctored["validation_accuracy"] = {k: [[100.0, 100.0]]
                                       for k in after_one["validation_accuracy"]}
    path = os.path.join(root, "doctored.pth")
    torch.save(doctored, path)
    cfg = load_config(overrides=_overrides(root, "doctored", "train.epochs=1",
                                           f"train.pre_trained={path}", "tpu.steps_per_call=2"))
    run_trainer(cfg, logging.getLogger("port_resume"), MODALITY, device="cpu")
    out = checkpoint_stem(cfg, MODALITY)
    assert _history(out)["epoch"] == 1
    assert not os.path.exists(out + "_best.pth")
    # tpu.steps_per_call: a warned no-op, every batch one step
    assert any("tpu.steps_per_call=2" in r.getMessage() for r in caplog.records
               if r.levelno == logging.WARNING)
    assert _load(out + ".pth")["step"] == after_one["step"] + 2
