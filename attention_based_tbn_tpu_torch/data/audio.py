"""Host audio IO: WAV loading and window extraction.

Port of the JAX package's ``data/audio.py`` with its pure-Python reader.
The reference loads the whole untrimmed video's audio with librosa for
every sample (core/dataset/dataset.py:372-419) and cuts an
``audio_length``-second window centred on the sampled frame
(dataset.py:421-459). Here the window cut is a pure function, the waveform
is cached per video, and the spectrogram runs on the device
(ops/spectrogram.py): the host ships raw waveform windows.
"""

from __future__ import annotations

import functools
import os
import threading
import wave

import numpy as np
from scipy import signal as scipy_signal


def read_wav(path: str, target_sr: int = 24000, mono: bool = True) -> np.ndarray:
    """A PCM WAV file as float32 in [-1, 1], resampled to ``target_sr`` by
    polyphase filtering (scipy; the reference's librosa uses resampy)."""
    with wave.open(path, "rb") as handle:
        sr = handle.getframerate()
        n_channels = handle.getnchannels()
        sample_width = handle.getsampwidth()
        raw = handle.readframes(handle.getnframes())

    if sample_width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sample_width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sample_width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width {sample_width} in {path}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels)
        if mono:
            data = data.mean(axis=1)
    if sr != target_sr:
        gcd = np.gcd(sr, target_sr)
        data = scipy_signal.resample_poly(data, target_sr // gcd, sr // gcd).astype(np.float32)
    return np.ascontiguousarray(data, dtype=np.float32)


def read_audio_sample(root_dir: str, audio_prefix: str, vid_id: str, file_ext: str = "wav",
                      sampling_rate: int = 24000, read_pickle: bool = False) -> np.ndarray:
    """The full untrimmed waveform of a video (a WAV file or an .npy cache)."""
    if read_pickle:
        return np.load(os.path.join(root_dir, audio_prefix, f"{vid_id}.npy")).astype(np.float32)
    return read_wav(os.path.join(root_dir, audio_prefix, f"{vid_id}.{file_ext}"),
                    target_sr=sampling_rate)


def extract_window(sample: np.ndarray, frame_idx: int, vid_fps: float, audio_length: float,
                   sampling_rate: int) -> np.ndarray:
    """The ``audio_length``-second window centred at ``frame_idx``: it
    starts at ``frame_idx / fps - audio_length / 2`` seconds, clamped into
    the sample; a sample shorter than one window is zero-padded on the
    right (reference dataset.py:439-451, whose negative start for such
    samples is clamped to 0 here, as in the JAX package)."""
    min_len = int(audio_length * sampling_rate)
    max_len = sample.shape[0]
    if max_len < min_len:
        sample = np.pad(sample, (0, min_len - max_len))
    start_sec = float(frame_idx) / vid_fps - audio_length / 2.0
    start = int(max(0.0, start_sec * sampling_rate))
    if start + min_len > max_len:
        start = max(max_len - min_len, 0)
    return np.ascontiguousarray(sample[start : start + min_len], dtype=np.float32)


class AudioCache:
    """LRU cache of untrimmed waveforms by video id. A per-video lock makes
    the loader's threads, which reach a new video's segments together,
    decode and resample its waveform once while the others wait."""

    def __init__(self, loader, max_items: int = 8):
        self._load = functools.lru_cache(maxsize=max_items)(loader)
        self._locks: dict = {}
        self._locks_guard = threading.Lock()

    def __call__(self, vid_id: str) -> np.ndarray:
        with self._locks_guard:
            lock = self._locks.setdefault(vid_id, threading.Lock())
        with lock:
            return self._load(vid_id)

    def clear(self) -> None:
        self._load.cache_clear()
        with self._locks_guard:
            self._locks.clear()
