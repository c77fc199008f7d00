#!/usr/bin/env python
"""Generate seen / unseen train-val split lists.

Port of the JAX package's ``preprocessing/create_split.py`` (reference
preprocessing/create_epic_split.py), reading the annotation CSV with the
``csv`` module where the JAX package uses pandas; the same lists:
* seen: participants P01-P24(ish); one held-out video per participant goes
  to validation, the rest to training;
* unseen: participants >= P25 form the validation set, everything below
  trains. (The reference has a latent ``ars`` typo at :68; fixed here.)

Usage:
  python -m attention_based_tbn_tpu_torch.preprocessing.create_split \
      --annotation /data/epic/annotations/epic_train_val.csv --out_dir data \
      --unseen_start 25
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def seen_split(video_ids, rng):
    by_participant = {}
    for vid in video_ids:
        by_participant.setdefault(vid.split("_")[0], []).append(vid)
    train, val = [], []
    for participant, vids in sorted(by_participant.items()):
        vids = sorted(vids)
        if len(vids) > 1:
            held = vids[int(rng.integers(len(vids)))]
            val.append(held)
            train.extend(v for v in vids if v != held)
        else:
            train.extend(vids)
    return train, val


def unseen_split(video_ids, unseen_start: int):
    train, val = [], []
    for vid in sorted(video_ids):
        participant_no = int(vid.split("_")[0][1:])
        (val if participant_no >= unseen_start else train).append(vid)
    return train, val


def write_list(path: str, vids) -> None:
    with open(path, "w") as handle:
        handle.write("\n".join(vids) + "\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--annotation", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--unseen_start", type=int, default=25)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    with open(args.annotation, newline="") as handle:
        video_ids = sorted({row["video_id"] for row in csv.DictReader(handle)})

    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    train_s, val_s = seen_split(video_ids, rng)
    write_list(os.path.join(args.out_dir, "train_split_seen.txt"), train_s)
    write_list(os.path.join(args.out_dir, "val_split_seen.txt"), val_s)

    train_u, val_u = unseen_split(video_ids, args.unseen_start)
    write_list(os.path.join(args.out_dir, "train_split_unseen.txt"), train_u)
    write_list(os.path.join(args.out_dir, "val_split_unseen.txt"), val_u)

    write_list(os.path.join(args.out_dir, "train_full.txt"), sorted(video_ids))
    print(
        f"seen: {len(train_s)} train / {len(val_s)} val; "
        f"unseen: {len(train_u)} train / {len(val_u)} val"
    )


if __name__ == "__main__":
    main()
