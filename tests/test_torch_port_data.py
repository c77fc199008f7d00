"""The port's host data pipeline against the JAX package's, on a fixture
that the JAX package's ``data/synthetic.generate`` writes (JPEG frames and
flow pairs, WAV audio, the annotation CSV) plus ``.npz`` flow stacks
(``preprocessing/create_flow_pickle``), an unlabelled CSV and class
tables: records, class ids, sampled indices in every mode, transforms,
decoded train / eval / 10-crop frames, audio windows, attention priors and
collated, padded batches. Everything is compared bit for bit (the same
numpy and cv2 calls run on both sides; the JAX side decodes through cv2
with ``tpu.native_io=false``).
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch

from attention_based_tbn_tpu.config import load_config as jax_load_config
from attention_based_tbn_tpu.data import synthetic
from attention_based_tbn_tpu.data import audio as jax_audio
from attention_based_tbn_tpu.data import classes as jax_classes
from attention_based_tbn_tpu.data import dataset as jax_dataset
from attention_based_tbn_tpu.data import loader as jax_loader
from attention_based_tbn_tpu.data import priors as jax_priors
from attention_based_tbn_tpu.data import records as jax_records
from attention_based_tbn_tpu.data import sampling as jax_sampling
from attention_based_tbn_tpu.data import transforms as jax_transforms
from attention_based_tbn_tpu.ops.spectrogram import log_power_stft_np as jax_stft_np
from attention_based_tbn_tpu.preprocessing.create_flow_pickle import process_video
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.data import audio, classes, dataset, loader, priors, records
from attention_based_tbn_tpu_torch.data import sampling, transforms
from attention_based_tbn_tpu_torch.ops.spectrogram import log_power_stft_np
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

VIDEOS = ["P01_01", "P02_03"]
UNLABELLED = ["uid", "participant_id", "video_id", "start_timestamp", "stop_timestamp",
              "start_frame", "stop_frame"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_data"))
    synthetic.generate(root, videos=VIDEOS, frames_per_video=70, actions_per_video=3,
                       image_hw=(40, 56), num_verbs=7, num_nouns=9)
    for vid in VIDEOS:
        process_video(os.path.join(root, "links", vid), os.path.join(root, "flow_pickle", vid),
                      5, "jpg")
    ann = os.path.join(root, "annotations")
    with open(os.path.join(ann, "epic_train_val.csv"), newline="") as fh:
        rows = list(csv.DictReader(fh))
    with open(os.path.join(ann, "test_s1.csv"), "w", newline="") as fh:
        writer = csv.DictWriter(fh, UNLABELLED)
        writer.writeheader()
        writer.writerows({k: r[k] for k in UNLABELLED} for r in rows)
    for name, key, ids in (("verb", "verbs", 7), ("noun", "nouns", 9)):
        with open(os.path.join(ann, f"EPIC_{name}_classes.csv"), "w", newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow([f"{name}_id", "class_key", key])
            for i in range(ids):
                writer.writerow([i, f"{name}{i}", str([f"{name}{i}", f"{name}{i}:alt"])])
    return root


def cfgs(root, *over):
    over = [f"data_dir={root}", "data.audio.audio_length=1.279", "data.train_scale_size=40",
            "data.train_crop_size=32", "data.test_scale_size=40", "data.test_crop_size=32",
            "model.num_classes={verb: 7, noun: 9}", "train.num_segments=3",
            "val.num_segments=2", "test.num_segments=2", "tpu.native_io=false"] + list(over)
    return load_config(overrides=over), jax_load_config(overrides=over)


def assert_same_tree(got, want, path="sample"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            assert_same_tree(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, np.ndarray):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("name", ["epic_train_val.csv", "test_s1.csv"])
@pytest.mark.parametrize("include_action", [False, True])
def test_records_match(root, name, include_action):
    path = os.path.join(root, "annotations", name)
    table = jax_records.load_annotations(path, ["P02_03"])
    rows = records.load_annotations(path, ["P02_03"])
    assert len(rows) == len(table) == 3
    for i, row in enumerate(rows):
        got = records.record_from_row(row, include_action)
        want = jax_records.record_from_row(table.iloc[i], include_action)
        assert got.__dict__ == want.__dict__
        assert (got.start_frame, got.end_frame, got.num_frames, got.label) == (
            want.start_frame, want.end_frame, want.num_frames, want.label)
    assert (got.label == -1) == (name == "test_s1.csv")
    assert len(records.load_annotations(path)) == 6
    if name == "epic_train_val.csv":  # the action filter needs the action column
        actions = [r["action"] for r in rows[:2]]
        filtered = records.load_annotations(path, None, actions)
        assert [r["uid"] for r in filtered] == [
            str(u) for u in jax_records.load_annotations(path, None, actions)["uid"]]


def test_vid_list_and_classes_match(root):
    split = os.path.join(root, "train_split.txt")
    assert records.read_vid_list(split) == jax_records.read_vid_list(split) == VIDEOS
    assert records.resolve_vid_list_path("data/x.txt") == jax_records.resolve_vid_list_path(
        "data/x.txt")
    assert records.resolve_vid_list_path(split) == split
    ann = os.path.join(root, "annotations")
    got, want = classes.EpicClasses(ann), jax_classes.EpicClasses(ann)
    assert got.verbs == want.verbs and got.nouns == want.nouns
    for verb, noun in (("verb3", "noun8"), ("verb6:alt", "noun0:alt")):
        assert got.action_id_string(verb, noun) == want.action_id_string(verb, noun)
    assert got.action_name(0) is None


@pytest.mark.parametrize("mode", ["train", "val", "test"])
@pytest.mark.parametrize("sampling_mode", ["sync", "async"])
def test_sampled_indices_match(root, mode, sampling_mode):
    path = os.path.join(root, "annotations", "epic_train_val.csv")
    table = jax_records.load_annotations(path)
    for i, row in enumerate(records.load_annotations(path)):
        rec = records.record_from_row(row)
        jrec = jax_records.record_from_row(table.iloc[i])
        for segments in (1, 3, 25):  # 25: degenerate spans collapse onto the start
            args = (["RGB", "Flow", "Audio"], segments, 5, mode, sampling_mode)
            got = sampling.sample_indices(rec, *args, rng=np.random.default_rng(i))
            want = jax_sampling.sample_indices(jrec, *args, rng=np.random.default_rng(i))
            assert_same_tree(got, want)
            assert_same_tree(sampling.flow_stack_indices(got["Flow"], 5, segments),
                             jax_sampling.flow_stack_indices(want["Flow"], 5, segments))


def test_transforms_match():
    frames = np.random.default_rng(0).integers(0, 255, (3, 40, 56, 10), np.uint8)
    for seed in range(6):
        args = (frames, 32, [1, 0.875, 0.75], 0.5)
        assert_same_tree(transforms.train_visual_transform(*args, np.random.default_rng(seed)),
                         jax_transforms.train_visual_transform(*args, np.random.default_rng(seed)))
    assert_same_tree(transforms.ten_crop(frames, 32), jax_transforms.ten_crop(frames, 32))
    for size in (40, 48, (36, 44)):
        assert_same_tree(transforms.rescale(frames, size), jax_transforms.rescale(frames, size))
    assert_same_tree(transforms.eval_visual_transform(frames, 48, 32),
                     jax_transforms.eval_visual_transform(frames, 48, 32))


def test_rescale_and_jpeg_without_cv2(root, monkeypatch):
    """No cv2: frames of the target size pass through; a resize and a JPEG
    decode raise and name the missing decoder."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    frames = np.zeros((2, 40, 56, 10), np.uint8)
    assert transforms.rescale(frames, 40) is frames
    with pytest.raises(ImportError, match="cv2"):
        transforms.rescale(frames, 32)
    cfg, _ = cfgs(root)
    ds = dataset.VideoDataset(cfg, None, "annotations/epic_train_val.csv", ["RGB"], mode="val")
    with pytest.raises(ImportError, match="JPEG"):
        ds.sample(0)


DATASET_CASES = {
    "train_rgb_flow_audio": ("train", ["RGB", "Flow", "Audio"], []),
    "val_flow_npz_audio": ("val", ["Flow", "Audio"], ["data.flow.read_flow_pickle=true",
                                                      "data.flow.dir_prefix=flow_pickle"]),
    "test_ten_crop": ("test", ["RGB", "Flow", "Audio"], ["test.ten_crop=true"]),
    "test_ten_crop_npz": ("test", ["Flow", "Audio"], ["test.ten_crop=true",
                                                      "data.flow.read_flow_pickle=true",
                                                      "data.flow.dir_prefix=flow_pickle"]),
    "fixed_gaussian": ("val", ["RGB", "Audio"], ["model.attention.use_fixed=true",
                                                 "model.attention.prior_type=gaussian"]),
    "fixed_loud": ("test", ["RGB", "Audio"], ["model.attention.use_fixed=true",
                                              "model.attention.prior_type=loud"]),
    "target_uniform": ("train", ["RGB", "Audio"], ["model.attention.use_prior=true",
                                                   "model.attention.prior_type=uniform"]),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_dataset_samples_match(root, case):
    mode, modality, over = DATASET_CASES[case]
    cfg, jcfg = cfgs(root, *over)
    args = (VIDEOS, "annotations/epic_train_val.csv", modality)
    got_ds = dataset.VideoDataset(cfg, *args, mode=mode)
    want_ds = jax_dataset.VideoDataset(jcfg, *args, mode=mode)
    assert len(got_ds) == len(want_ds) == 6
    for i in (0, 4):
        got = got_ds.sample(i, np.random.default_rng(i))
        want = want_ds.sample(i, np.random.default_rng(i))
        assert_same_tree(got, want)
    if "test_ten_crop" in case:
        assert got["Flow"].shape == (20, 32, 32, 10)


def test_audio_and_loud_prior_match(root):
    path = os.path.join(root, "audio", "P01_01.wav")
    for sr in (24000, 16000):
        assert_same_tree(audio.read_wav(path, sr), jax_audio.read_wav(path, sr))
    wave = audio.read_wav(path)
    for frame in (0, 40, 10_000):
        assert_same_tree(audio.extract_window(wave, frame, 60.0, 1.279, 24000),
                         jax_audio.extract_window(wave, frame, 60.0, 1.279, 24000))
    window = audio.extract_window(wave, 40, 60.0, 1.279, 24000)
    spec = log_power_stft_np(window)
    assert_same_tree(spec, jax_stft_np(window))
    for win in (8, 13):
        assert_same_tree(priors.attention_prior("loud", win, spec),
                         jax_priors.attention_prior("loud", win, spec))
        for kind in ("gaussian", "uniform"):
            assert_same_tree(priors.attention_prior(kind, win),
                             jax_priors.attention_prior(kind, win))


@pytest.mark.parametrize("name", ["epic_train_val.csv", "test_s1.csv"])
def test_loader_batches_match(root, name):
    """Shuffled batches of 4 out of 6 clips, the ragged last one padded to a
    multiple of 4: the same arrays, targets, padding and indices."""
    cfg, jcfg = cfgs(root, "data.flow.read_flow_pickle=true", "data.flow.dir_prefix=flow_pickle")
    args = (VIDEOS, f"annotations/{name}", ["Flow", "Audio"])
    got_loader = loader.DataLoader(dataset.VideoDataset(cfg, *args, mode="train"), 4,
                                   shuffle=True, num_workers=2, seed=3, pad_to=4)
    want_loader = jax_loader.DataLoader(jax_dataset.VideoDataset(jcfg, *args, mode="train"), 4,
                                        shuffle=True, num_workers=2, seed=3, pad_to=4)
    got_loader.set_epoch(1)
    want_loader.set_epoch(1)
    pairs = list(zip(got_loader, want_loader))
    assert len(pairs) == len(got_loader) == 2
    for (batch, targets, meta), (jbatch, jtargets, jmeta) in pairs:
        assert_same_tree(batch, jbatch)
        assert_same_tree(targets, jtargets)
        for key in ("batch_size", "uid", "vid_id", "start_time", "stop_time"):
            assert meta[key] == jmeta[key], key
        assert_same_tree(meta["global_indices"], jmeta["global_indices"])
    (last_batch, _, last_meta), _ = pairs[-1]
    assert last_meta["batch_size"] == 2 and last_batch["Flow"].shape[0] == 4


def test_loader_puts_batches_on_the_device(root):
    cfg, _ = cfgs(root, "data.flow.read_flow_pickle=true", "data.flow.dir_prefix=flow_pickle",
                  "test.batch_size=4", "num_workers=2", "test.vid_list=" + os.path.join(
                      root, "train_split.txt"), "test.annotation_file=annotations/test_s1.csv")
    test_loader = loader.create_dataloader(cfg, ["Flow", "Audio"], mode="test", device="cpu")
    batches = list(test_loader)
    assert [m["batch_size"] for _, _, m in batches] == [4, 2]
    batch, targets, meta = batches[0]
    assert isinstance(batch["Flow"], torch.Tensor) and batch["Flow"].dtype == torch.uint8
    assert targets["class"] is None  # unlabelled
    np.testing.assert_array_equal(meta["global_indices"], [0, 1, 2, 3])
