"""Audio spectrograms inside the forward pass, as one matmul per batch.

Port of the JAX package's ``ops/spectrogram.py``. The reference computes
log-power STFTs on the host with librosa (n_fft 511, periodic Hann of
10 ms zero-padded to n_fft, 5 ms hop, centre zero padding,
``log(|S|^2 + 1e-6)``); here the raw waveform window reaches the device and
the windowed DFT is a matmul against a precomputed (n_fft, n_bins) basis.

Framing is polyphase: the padded waveform splits into hop-sized blocks, and
frame t is blocks t .. t + ceil(n_fft / hop) - 1 laid side by side, so the
frames are ceil(n_fft/hop) shifted views concatenated once, times the basis
zero-padded to that width.

``compute_dtype`` rounds the waveform and the basis as the JAX code does;
the product itself runs in float32 (bf16-rounded operands are exact there,
and under TF32), so bf16 mode matches the JAX package's bf16 inputs with
float32 accumulation and output.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def periodic_hann(win_length: int) -> np.ndarray:
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def _padded_window(win_length: int, n_fft: int) -> np.ndarray:
    window = periodic_hann(win_length)
    padded = np.zeros(n_fft, dtype=np.float64)
    left = (n_fft - win_length) // 2
    padded[left : left + win_length] = window
    return padded


@functools.lru_cache(maxsize=8)
def dft_basis(n_fft: int, win_length: int):
    """Windowed real-DFT basis: (n_fft, n_bins) cos / -sin matrices; frames
    times them give Re / Im of rfft(window * frame)."""
    n_bins = n_fft // 2 + 1
    window = _padded_window(win_length, n_fft)
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    angle = -2.0 * np.pi * n * k / n_fft
    cos_basis = (window[:, None] * np.cos(angle)).astype(np.float32)
    sin_basis = (window[:, None] * np.sin(angle)).astype(np.float32)
    return cos_basis, sin_basis


@functools.lru_cache(maxsize=8)
def _wide_basis(n_fft: int, win_length: int, hop: int, device: str, dtype: torch.dtype):
    """[cos | sin] basis zero-padded to ceil(n_fft/hop)*hop rows, rounded to
    ``dtype`` and held on ``device`` as float32."""
    cos_b, sin_b = dft_basis(n_fft, win_length)
    n_chunks = -(-n_fft // hop)
    wide = np.zeros((n_chunks * hop, 2 * cos_b.shape[1]), np.float32)
    wide[:n_fft] = np.concatenate([cos_b, sin_b], axis=1)
    return torch.from_numpy(wide).to(device=device, dtype=dtype).float()


def _stft_power(signal_2d: torch.Tensor, n_fft: int, win_length: int, hop: int,
                compute_dtype: torch.dtype) -> torch.Tensor:
    """(B, L) waveform -> (B, T, n_bins) float32 power."""
    pad = n_fft // 2
    b, length = signal_2d.shape
    l2 = length + 2 * pad
    t_frames = 1 + (l2 - n_fft) // hop
    n_chunks = -(-n_fft // hop)
    n_blocks = t_frames + n_chunks
    padded = F.pad(signal_2d.to(compute_dtype), (pad, pad + n_blocks * hop - l2))
    blocks = padded.view(b, n_blocks, hop)
    frames = torch.cat([blocks[:, j : j + t_frames] for j in range(n_chunks)], dim=-1)
    basis = _wide_basis(n_fft, win_length, hop, str(signal_2d.device), compute_dtype)
    out = torch.matmul(frames.float(), basis)
    n_bins = basis.shape[1] // 2
    re, im = out[..., :n_bins], out[..., n_bins:]
    return re * re + im * im


def _frame_params(sr: int, window_ms: float, hop_ms: float):
    return int(round(window_ms * sr / 1e3)), int(round(hop_ms * sr / 1e3))


def log_power_stft(signal: torch.Tensor, sr: int = 24000, n_fft: int = 511,
                   window_ms: float = 10.0, hop_ms: float = 5.0, eps: float = 1e-6,
                   compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., L) waveform -> (..., n_bins, n_frames) float32 log power; a
    2.1 s window at 24 kHz gives 256 x 420."""
    win_length, hop = _frame_params(sr, window_ms, hop_ms)
    lead = signal.shape[:-1]
    power = _stft_power(signal.reshape(-1, signal.shape[-1]), n_fft, win_length, hop,
                        compute_dtype)
    spec = torch.log(power + eps).transpose(-1, -2)
    return spec.reshape(lead + spec.shape[1:])


def hz_to_mel(freq) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    linear = freq / f_sp
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        linear,
    )


def mel_to_hz(mels) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels
    )


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_bins, n_mels)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels]))[:, None]
    return weights.T.astype(np.float32)


def log_mel_spectrogram(signal: torch.Tensor, sr: int = 24000, n_fft: int = 511,
                        window_ms: float = 10.0, hop_ms: float = 5.0, n_mels: int = 128,
                        top_db: float = 80.0,
                        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(..., L) -> (..., n_mels, n_frames): librosa melspectrogram then
    power_to_db with ref=max (per sample), amin=1e-10, top_db=80."""
    win_length, hop = _frame_params(sr, window_ms, hop_ms)
    lead = signal.shape[:-1]
    power = _stft_power(signal.reshape(-1, signal.shape[-1]), n_fft, win_length, hop,
                        compute_dtype)
    mel_b = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(signal.device)
    mel = torch.matmul(power, mel_b).transpose(-1, -2)  # (B, n_mels, T)
    amin = 1e-10
    log_spec = 10.0 * torch.log10(torch.clamp(mel, min=amin))
    ref = mel.amax(dim=(-2, -1), keepdim=True)
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - top_db)
    return log_spec.reshape(lead + log_spec.shape[1:])


def spectrogram(signal: torch.Tensor, spec_type: str = "stft", sr: int = 24000,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if spec_type == "stft":
        return log_power_stft(signal, sr=sr, compute_dtype=compute_dtype)
    if spec_type == "logms":
        return log_mel_spectrogram(signal, sr=sr, compute_dtype=compute_dtype)
    raise ValueError(f"Unknown spectrogram representation {spec_type!r}")
