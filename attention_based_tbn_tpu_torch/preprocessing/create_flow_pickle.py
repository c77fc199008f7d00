#!/usr/bin/env python
"""Interleaved optical-flow stacks -> per-frame .npz caches.

Port of the JAX package's ``preprocessing/create_flow_pickle.py`` (reference
preprocessing/create_epic_flow_pickle.py), decoding through the port's
native library (bit-equal to the JAX package's ``cv2.imread(path, 0)``).
A missing frame ends the stacks, as there. A frame that is present but will
not decode raises ``IOError`` naming the file, where ``cv2.imread``'s None
ends them quietly: that covers a corrupt file and one the native decoder
refuses (progressive, arithmetic-coded, multi-scan). For every flow frame
index, read the next ``win_length`` (x, y) JPEG pairs, stack
them into an (H, W, 2*win) uint8 array, and write ``frame_%010d.npz`` with
an integrity-check/retry loop (the reference guards against concurrent-write
corruption the same way, create_epic_flow_pickle.py:112-213).

Usage:
  python -m attention_based_tbn_tpu_torch.preprocessing.create_flow_pickle \
      --in_dir /data/epic/links --out_dir /data/epic/flow_pickle --win_length 5
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native


def build_stack(video_dir: str, frame_idx: int, win_length: int, ext: str):
    library = native.ensure_built()
    maps = []
    for offset in range(win_length):
        for axis in ("x", "y"):
            path = os.path.join(video_dir, f"{axis}_{frame_idx + offset:010d}.{ext}")
            if not os.path.exists(path):  # past the last full window
                return None
            maps.append(library.decode_jpeg_file(path, grayscale=True))
    return np.stack(maps, axis=2)  # (H, W, 2*win)


def integrity_check(path: str, expected_shape) -> bool:
    try:
        with np.load(path) as data:
            return data["flow"].shape == expected_shape
    except Exception:
        return False


def process_video(video_dir: str, out_dir: str, win_length: int, ext: str,
                  retries: int = 3) -> int:
    os.makedirs(out_dir, exist_ok=True)
    frames = sorted(
        int(f.split("_")[1].split(".")[0])
        for f in os.listdir(video_dir)
        if f.startswith("x_")
    )
    written = 0
    for idx in frames:
        stack = build_stack(video_dir, idx, win_length, ext)
        if stack is None:
            continue  # ran past the last full window
        out_path = os.path.join(out_dir, f"frame_{idx:010d}.npz")
        for _ in range(retries):
            np.savez_compressed(out_path, flow=stack)
            if integrity_check(out_path, stack.shape):
                written += 1
                break
        else:
            # Every retry failed the integrity check (full disk, flaky
            # storage, ...). Leaving the corrupt npz behind would crash
            # training much later when the loader opens it — remove it and
            # fail loudly here instead.
            try:
                os.remove(out_path)
            except OSError:
                pass
            raise IOError(
                f"flow stack {out_path} failed integrity check "
                f"{retries} times; removed the corrupt file"
            )
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--in_dir", required=True, help="links tree with x_/y_ files")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--win_length", type=int, default=5)
    parser.add_argument("--ext", default="jpg")
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)

    videos = sorted(
        v for v in os.listdir(args.in_dir)
        if os.path.isdir(os.path.join(args.in_dir, v))
    )
    # one worker per video, videos processed in parallel — writes never
    # collide because each video owns its output directory
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        counts = list(
            pool.map(
                lambda v: process_video(
                    os.path.join(args.in_dir, v),
                    os.path.join(args.out_dir, v),
                    args.win_length,
                    args.ext,
                ),
                videos,
            )
        )
    print(f"Wrote {sum(counts)} flow stacks for {len(videos)} videos")


if __name__ == "__main__":
    main()
