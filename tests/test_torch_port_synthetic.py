"""The port's fixture writer (``data/synthetic.generate``) against the JAX
package's, with the same arguments and seed: every file of the tree (the
JPEG frames and flow pairs, the WAV files, the annotation CSV and the
split list) byte-identical: both write their JPEGs with cv2.imwrite.
Then the label signal of ``learnable`` and ``class_jitter``, as
``tests/test_synthetic_jitter.py`` checks it on the JAX side.
"""

import csv
import os

import numpy as np
import pytest

from attention_based_tbn_tpu.data import synthetic as jax_synthetic
from attention_based_tbn_tpu_torch import native
from attention_based_tbn_tpu_torch.data import synthetic

ARGS = dict(videos=["P01_01", "P02_03"], frames_per_video=30, actions_per_video=2,
            image_hw=(37, 53), num_verbs=5, num_nouns=7, seed=3)
CASES = {
    "plain": {},
    "learnable": dict(learnable=True),
    "jitter": dict(learnable=True, class_jitter=0.6),
    "noun_jitter": dict(learnable=True, class_jitter=0.5, noun_jitter=0.2),
    "defaults": dict(videos=None, frames_per_video=20, image_hw=(24, 40), num_verbs=125,
                     num_nouns=352, seed=0),
}


def read_tree(root):
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                files[os.path.relpath(path, root)] = fh.read()
    return files


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_byte_identical_to_jax(tmp_path, case):
    args = {**ARGS, **CASES[case]}
    want_root, got_root = str(tmp_path / "jax"), str(tmp_path / "port")
    assert synthetic.generate(got_root, **args) == jax_synthetic.generate(want_root, **args)
    got, want = read_tree(got_root), read_tree(want_root)
    assert sorted(got) == sorted(want)
    assert any(name.endswith(".jpg") for name in got) and "train_split.txt" in got
    for name in want:
        assert got[name] == want[name], name


def test_prefixes_and_jitter_rules(tmp_path):
    with pytest.raises(ValueError, match="learnable"):
        synthetic.generate(str(tmp_path / "bad"), class_jitter=0.5)
    args = {**ARGS, "rgb_prefix": "rgb", "flow_prefix": "flow", "audio_prefix": "wav"}
    synthetic.generate(str(tmp_path / "port"), **args)
    jax_synthetic.generate(str(tmp_path / "jax"), **args)
    assert read_tree(str(tmp_path / "port")) == read_tree(str(tmp_path / "jax"))
    assert os.path.isdir(tmp_path / "port" / "flow" / "P02_03")


def labels(root):
    with open(os.path.join(root, "annotations", "epic_train_val.csv"), newline="") as fh:
        return [(r["uid"], r["verb_class"], r["noun_class"]) for r in csv.DictReader(fh)]


def test_jitter_moves_content_not_labels(tmp_path):
    """As test_synthetic_jitter.py: jitter changes the class-coded frames
    and audio, never the labels; the learnable signal sits in the same
    brightness band as the JAX package's."""
    args = {**ARGS, "image_hw": (48, 64), "learnable": True}
    plain, jittered = str(tmp_path / "a"), str(tmp_path / "b")
    synthetic.generate(plain, **args)
    synthetic.generate(jittered, **args, class_jitter=0.6)
    assert labels(plain) == labels(jittered)
    frame = os.path.join("links", "P01_01", "img_0000000005.jpg")
    lib = native.load()
    a = lib.decode_jpeg_file(os.path.join(plain, frame))
    b = lib.decode_jpeg_file(os.path.join(jittered, frame))
    assert abs(float(a.mean()) - float(b.mean())) > 0.5
    assert 20 < b.mean() < 235
    # the verb signal: the upper half's brightness rises with the verb class
    uppers = {}
    for uid, verb, _ in labels(plain):
        start = 2 + (int(uid) % 2) * 15
        vid = ARGS["videos"][int(uid) // 2]
        img = lib.decode_jpeg_file(os.path.join(plain, "links", vid, f"img_{start:010d}.jpg"))
        uppers[int(verb)] = float(img[:24].mean())
    assert list(uppers) and sorted(uppers, key=uppers.get) == sorted(uppers)
    with open(os.path.join(jittered, "audio", "P01_01.wav"), "rb") as fh:
        audio = fh.read()
    synthetic.generate(str(tmp_path / "c"), **args, class_jitter=0.6)
    with open(tmp_path / "c" / "audio" / "P01_01.wav", "rb") as fh:
        assert fh.read() == audio  # deterministic
    with open(os.path.join(plain, "audio", "P01_01.wav"), "rb") as fh:
        plain_audio = fh.read()
    assert len(plain_audio) == len(audio) and not np.array_equal(
        np.frombuffer(audio[44:], "<i2"), np.frombuffer(plain_audio[44:], "<i2"))
