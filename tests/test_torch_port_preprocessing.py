"""The port's four preprocessing CLIs against the JAX package's on the same
input trees, through their ``main`` with the same arguments: symlink
targets equal, ``.npz`` flow stacks bit-equal (the port decodes through
its native library, the JAX package through cv2),
``.npy`` audio caches equal, split lists equal. Each also runs as
``python -m attention_based_tbn_tpu_torch.preprocessing.<name>``.
"""

import csv
import os
import subprocess
import sys
import wave

import numpy as np
import pytest

from attention_based_tbn_tpu.data import synthetic as jax_synthetic
from attention_based_tbn_tpu.preprocessing import create_audio_pickle as jax_audio_pickle
from attention_based_tbn_tpu.preprocessing import create_flow_pickle as jax_flow_pickle
from attention_based_tbn_tpu.preprocessing import create_split as jax_split
from attention_based_tbn_tpu.preprocessing import create_symlinks as jax_symlinks
from attention_based_tbn_tpu_torch.preprocessing import (
    create_audio_pickle,
    create_flow_pickle,
    create_split,
    create_symlinks,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def links(root):
    """{video/link: target} of every symlink under a links tree."""
    out = {}
    for video in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, video))):
            out[f"{video}/{name}"] = os.readlink(os.path.join(root, video, name))
    return out


def test_symlinks_match(tmp_path):
    raw = tmp_path / "frames"
    for participant, video, frames in (("P01", "P01_01", 4), ("P01", "P01_02", 2),
                                       ("P03", "P03_01", 3)):
        vdir = raw / participant / video
        for sub in ("", "u", "v"):
            (vdir / sub).mkdir(parents=True, exist_ok=True)
            for i in range(1, frames + 1):
                (vdir / sub / f"frame_{i:010d}.jpg").write_bytes(b"x")
    (raw / "P01" / "notes.txt").write_text("not a video")
    create_symlinks.main(["--in_dir", str(raw), "--out_dir", str(tmp_path / "port")])
    jax_symlinks.main(["--in_dir", str(raw), "--out_dir", str(tmp_path / "jax")])
    got, want = links(tmp_path / "port"), links(tmp_path / "jax")
    assert got == want and len(got) == 3 * (4 + 2 + 3)
    assert got["P01_01/x_0000000000.jpg"].endswith("u/frame_0000000001.jpg")


def test_flow_pickle_matches(tmp_path):
    jax_synthetic.generate(str(tmp_path / "fx"), videos=["P01_01", "P02_01"],
                           frames_per_video=24, image_hw=(40, 56))
    links_dir = str(tmp_path / "fx" / "links")
    args = ["--in_dir", links_dir, "--win_length", "5", "--workers", "2"]
    create_flow_pickle.main(args + ["--out_dir", str(tmp_path / "port")])
    jax_flow_pickle.main(args + ["--out_dir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax" / "P02_01"))
    assert len(names) == 24 // 2 + 10 - 4  # every flow frame with a full window
    for vid in ("P01_01", "P02_01"):
        assert sorted(os.listdir(tmp_path / "port" / vid)) == sorted(
            os.listdir(tmp_path / "jax" / vid))
        for name in names:
            with np.load(tmp_path / "port" / vid / name) as got, \
                    np.load(tmp_path / "jax" / vid / name) as want:
                assert got["flow"].shape == (40, 56, 10) and got["flow"].dtype == np.uint8
                np.testing.assert_array_equal(got["flow"], want["flow"])


def test_audio_pickle_matches(tmp_path):
    in_dir = tmp_path / "audio"
    in_dir.mkdir()
    rng = np.random.default_rng(0)
    for vid, sr in (("P01_01", 48000), ("P02_01", 44100), ("P03_01", 24000)):
        pcm = (np.clip(rng.standard_normal(sr // 2) * 0.2, -1, 1) * 32767).astype("<i2")
        with wave.open(str(in_dir / f"{vid}.wav"), "wb") as handle:
            handle.setnchannels(1)
            handle.setsampwidth(2)
            handle.setframerate(sr)
            handle.writeframes(pcm.tobytes())
    (in_dir / "readme.txt").write_text("skipped")
    args = ["--in_dir", str(in_dir), "--sr", "24000", "--workers", "2"]
    create_audio_pickle.main(args + ["--out_dir", str(tmp_path / "port")])
    jax_audio_pickle.main(args + ["--out_dir", str(tmp_path / "jax")])
    assert sorted(os.listdir(tmp_path / "port")) == ["P01_01.npy", "P02_01.npy", "P03_01.npy"]
    for name in os.listdir(tmp_path / "jax"):
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert got.dtype == np.float32 and abs(len(got) - 12000) <= 1
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", ["progressive", "corrupt"])
def test_flow_pickle_raises_on_a_frame_it_cannot_decode(tmp_path, bad):
    """A Flow frame that is there but will not decode raises and names the
    file. The JAX CLI's cv2.imread decodes a progressive file, which the
    port's decoder refuses, and returns None at a corrupt one, which ends
    the stacks: here neither may quietly write fewer stacks."""
    import cv2

    jax_synthetic.generate(str(tmp_path / "fx"), videos=["P01_01"], frames_per_video=24,
                           image_hw=(40, 56))
    vdir = tmp_path / "fx" / "links" / "P01_01"
    path = vdir / sorted(f for f in os.listdir(vdir) if f.startswith("y_"))[2]
    if bad == "progressive":
        cv2.imwrite(str(path), cv2.imread(str(path), 0), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        assert cv2.imread(str(path), 0) is not None  # what the JAX CLI reads
        match = "progressive JPEG"
    else:
        path.write_bytes(path.read_bytes()[:40])
        match = "corrupt JPEG"
    with pytest.raises(IOError, match=match) as info:
        create_flow_pickle.main(["--in_dir", str(tmp_path / "fx" / "links"), "--out_dir",
                                 str(tmp_path / "port"), "--win_length", "5"])
    assert str(path) in str(info.value)


def write_annotations(path, videos):
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["uid", "participant_id", "video_id", "verb_class", "noun_class"])
        for uid, vid in enumerate(videos):
            writer.writerow([uid, vid[:3], vid, uid % 5, uid % 7])


@pytest.mark.parametrize("seed", [0, 3])
def test_split_lists_match(tmp_path, seed):
    videos = [f"P{p:02d}_{v:02d}" for p in (1, 2, 7, 24, 25, 26, 31) for v in range(1, 5 - p % 3)]
    ann = str(tmp_path / "epic_train_val.csv")
    write_annotations(ann, videos + videos[:5])  # repeated ids, as one row per action
    args = ["--annotation", ann, "--unseen_start", "25", "--seed", str(seed)]
    create_split.main(args + ["--out_dir", str(tmp_path / "port")])
    jax_split.main(args + ["--out_dir", str(tmp_path / "jax")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 5
    for name in names:
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert (tmp_path / "port" / "val_split_unseen.txt").read_text().startswith("P25_01")


def test_cli_runs_as_module(tmp_path):
    ann = str(tmp_path / "a.csv")
    write_annotations(ann, ["P01_01", "P01_02", "P30_01"])
    out = subprocess.run([sys.executable, "-m",
                          "attention_based_tbn_tpu_torch.preprocessing.create_split",
                          "--annotation", ann, "--out_dir", str(tmp_path / "lists")],
                         capture_output=True, text=True, cwd=REPO, timeout=120, check=True)
    assert "unseen: 2 train / 1 val" in out.stdout
    assert (tmp_path / "lists" / "train_full.txt").read_text() == "P01_01\nP01_02\nP30_01\n"
