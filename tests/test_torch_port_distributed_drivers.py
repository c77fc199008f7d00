"""The port's ``main`` on 2 gloo ranks on the CPU (spawned with torchrun's
variables, tests/torch_port_dist.py) against ``main`` in one process, on a
small synthetic fixture (RGB + Audio, MHA, 64-px crops, 2 segments,
float32, the default dropout 0.5): train 1 epoch with validation, resume 1
more from the ``.pth``, then test mode from that ``.pth`` with the
challenge JSON.

Held: rank 0 alone writes the checkpoints, histories and the JSON; the
ranks end every run with bit-equal states; the resume extends the epochs
from the file every rank read; the 2-rank training matches one process's
(epoch losses within rtol 1e-4: four steps of the chaotic training of
tests/test_torch_port_train_step.py; the validation losses within 1e-3);
and test mode on 2 ranks writes the 1-process JSON (the same uids in the
same order, scores within rel 1e-5) with the same loss and accuracy."""

import json
import os

import numpy as np
import pytest
import torch

from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.data import synthetic
from attention_based_tbn_tpu_torch.tools.train import checkpoint_stem
from torch_port_dist import main_case, run_ranks
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

VIDEOS = ["P01_01", "P02_03"]
NAME = "epic_tbn_bninception_RGB_Audio"  # the checkpoint's file stem


def _overrides(root, exp, *extra):
    split = os.path.join(root, "train_split.txt")
    return [
        "tpu.platform=cpu", f"data_dir={root}", f"out_dir={root}/out", f"exp_name={exp}",
        "num_workers=2", "data.flow.enable=false", "data.audio.audio_length=1.279",
        "data.train_scale_size=72", "data.train_crop_size=64", "data.test_scale_size=72",
        "data.test_crop_size=64", "model.num_classes={verb: 7, noun: 9}",
        "model.pretrained=false", "tpu.compute_dtype=float32", f"train.vid_list={split}",
        "train.batch_size=4", "train.num_segments=2", f"val.vid_list={split}",
        "val.batch_size=2", "val.num_segments=2", "test.num_segments=2",
        "test.batch_size=2", f"test.vid_list={split}", *extra,
    ]


def _runs(root, exp, test_weights):
    train = _overrides(root, exp, "train.enable=true", "test.enable=false", "train.epochs=1")
    stem = checkpoint_stem(load_config(overrides=train), ["RGB", "Audio"])
    resume = train + [f"train.pre_trained={stem}.pth"]
    test = _overrides(root, exp + "_test", "train.enable=false", "test.enable=true",
                      f"test.pre_trained={test_weights}", "test.save_results=true",
                      "test.annotation_file=[annotations/epic_train_val.csv]",
                      "test.results_file=[scores.json]")
    return stem, [train, resume, test]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("port_dist_drivers"))
    synthetic.generate(root, videos=VIDEOS, frames_per_video=60, actions_per_video=3,
                       image_hw=(72, 96), num_verbs=7, num_nouns=9)
    stem, argv = _runs(root, "ranks", None)
    argv[2] = _runs(root, "ranks", stem + ".pth")[1][2]
    ranks = run_ranks("main", 2, argv)
    with open(os.path.join(root, "out", "inferences", "scores.json")) as fh:
        rank_json = json.load(fh)
    one_stem, one_argv = _runs(root, "one", stem + ".pth")
    one = main_case(one_argv)
    with open(os.path.join(root, "out", "inferences", "scores.json")) as fh:
        one_json = json.load(fh)
    histories = []
    for s in (stem, one_stem):
        with open(s + ".history.json") as fh:
            histories.append(json.load(fh))
    return dict(ranks=ranks, one=one, rank_json=rank_json, one_json=one_json,
                histories=histories)


def test_rank_zero_alone_writes(runs):
    first, second = runs["ranks"]
    assert all(run["world"] == 2 for run in first + second)
    for run in second:
        assert run["writes"] == []
    train, resume, test = first
    for run in (train, resume):
        assert sorted(run["writes"]) == [NAME + ".history.json", NAME + ".pth"]
    assert test["writes"] == ["scores.json"]


@pytest.mark.parametrize("run", [0, 1])
def test_ranks_end_equal(runs, run):
    """Bit-equal, and equal to the checkpoint every rank would restore."""
    first, second = (r[run] for r in runs["ranks"])
    assert first["hash"] == second["hash"] == first["file_hash"]
    assert torch.equal(first["generator"], second["generator"])
    assert first["step"] == second["step"] == 2 * (run + 1)  # 6 clips: batches of 4 and 2


def test_resume_extends_the_epochs(runs):
    ranks, one = runs["histories"]
    for history in (ranks, one):
        assert history["epoch"] == 1
        assert len(history["train_loss"]) == len(history["validation_loss"]) == 2


def test_training_matches_one_process(runs):
    """Epoch losses, and the final parameters within rel-RMSE 1e-3 (the
    smoke's bound for the flagship's steps across ranks); the running
    statistics within 1e-2: at 64 px the last BatchNorms see 2 x 2 maps of
    4 rows, whose single-pass float32 variance cancels, so their running
    variances carry the reduction order's noise most."""
    ranks, one = runs["histories"]
    for got, want in zip(ranks["train_loss"], one["train_loss"]):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    for got, want in zip(ranks["validation_loss"], one["validation_loss"]):
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    assert runs["one"][1]["world"] == 1
    got, want = runs["ranks"][0][1]["state"], runs["one"][1]["state"]
    for stats, bound in ((False, 1e-3), (True, 1e-2)):
        keys = [k for k, v in want.items()
                if v.is_floating_point() and ("running_" in k) == stats]
        num = sum(float((got[k].double() - want[k].double()).square().sum()) for k in keys)
        den = sum(float(want[k].double().square().sum()) for k in keys)
        assert np.sqrt(num / den) < bound, ("running statistics" if stats else "parameters")


def test_test_mode_writes_the_one_process_json(runs):
    got, want = runs["rank_json"]["results"], runs["one_json"]["results"]
    assert list(got) == list(want) and len(want) == 6
    for uid, scores in want.items():
        for head in ("verb", "noun"):
            a = np.array(list(got[uid][head].values()))
            b = np.array(list(scores[head].values()))
            assert list(got[uid][head]) == list(scores[head])
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=uid)
    (rank_loss, rank_acc, _), = runs["ranks"][0][2]["results"]
    (one_loss, one_acc, _), = runs["one"][2]["results"]
    for key in one_loss:
        np.testing.assert_allclose(rank_loss[key], one_loss[key], rtol=1e-5, err_msg=key)
    assert rank_acc == one_acc
    assert runs["ranks"][1][2]["results"][0][1] == rank_acc  # every rank's metrics
