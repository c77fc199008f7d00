#!/usr/bin/env python
"""WAV -> resampled mono float32 .npy cache.

Port of the JAX package's ``preprocessing/create_audio_pickle.py``
(reference preprocessing/create_audio_pickle.py): loading the full
untrimmed WAV per sample dominates host time; the .npy cache
(data.audio.read_audio_pickle=True) loads at once. Like the JAX package's,
it resamples with the Python reader (scipy's polyphase filter), not the
native one.

Usage:
  python -m attention_based_tbn_tpu_torch.preprocessing.create_audio_pickle \
      --in_dir /data/epic/audio --out_dir /data/epic/audio_npy --sr 24000
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..data.audio import read_wav


def convert_one(in_path: str, out_path: str, sr: int) -> str:
    data = read_wav(in_path, target_sr=sr, mono=True)
    np.save(out_path, data)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--in_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--sr", type=int, default=24000)
    parser.add_argument("--workers", type=int, default=8)
    args = parser.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    jobs = []
    for name in sorted(os.listdir(args.in_dir)):
        if not name.endswith(".wav"):
            continue
        vid = os.path.splitext(name)[0]
        jobs.append(
            (
                os.path.join(args.in_dir, name),
                os.path.join(args.out_dir, f"{vid}.npy"),
            )
        )

    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        results = list(
            pool.map(lambda j: convert_one(j[0], j[1], args.sr), jobs)
        )
    print(f"Wrote {len(results)} audio pickles to {args.out_dir}")


if __name__ == "__main__":
    main()
