#!/usr/bin/env python
"""Create 0-indexed symlink trees for Epic-Kitchens frames.

Port of the JAX package's ``preprocessing/create_symlinks.py`` (reference
preprocessing/create_epic_symlinks.py): the raw
dataset ships 1-indexed ``frame_%010d.jpg`` RGB and ``u/ v/`` flow files;
training reads 0-indexed ``img_/x_/y_%010d.jpg`` names from one flat links
tree per video.

Usage:
  python -m attention_based_tbn_tpu_torch.preprocessing.create_symlinks \
      --in_dir /data/epic/frames --out_dir /data/epic/links
"""

from __future__ import annotations

import argparse
import os


def link_video(video_dir: str, out_dir: str) -> int:
    os.makedirs(out_dir, exist_ok=True)
    count = 0

    rgb_files = sorted(
        f for f in os.listdir(video_dir)
        if f.startswith("frame_") and not os.path.isdir(os.path.join(video_dir, f))
    )
    for new_idx, name in enumerate(rgb_files):
        ext = name.rsplit(".", 1)[-1]
        target = os.path.join(out_dir, f"img_{new_idx:010d}.{ext}")
        if not os.path.lexists(target):
            os.symlink(os.path.join(video_dir, name), target)
            count += 1

    for axis, prefix in (("u", "x"), ("v", "y")):
        flow_dir = os.path.join(video_dir, axis)
        if not os.path.isdir(flow_dir):
            continue
        for new_idx, name in enumerate(sorted(os.listdir(flow_dir))):
            ext = name.rsplit(".", 1)[-1]
            target = os.path.join(out_dir, f"{prefix}_{new_idx:010d}.{ext}")
            if not os.path.lexists(target):
                os.symlink(os.path.join(flow_dir, name), target)
                count += 1
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--in_dir", required=True, help="raw frames root")
    parser.add_argument("--out_dir", required=True, help="links tree root")
    args = parser.parse_args(argv)

    total = 0
    for participant in sorted(os.listdir(args.in_dir)):
        p_dir = os.path.join(args.in_dir, participant)
        if not os.path.isdir(p_dir):
            continue
        for video in sorted(os.listdir(p_dir)):
            v_dir = os.path.join(p_dir, video)
            if not os.path.isdir(v_dir):
                continue
            total += link_video(v_dir, os.path.join(args.out_dir, video))
    print(f"Created {total} symlinks under {args.out_dir}")


if __name__ == "__main__":
    main()
