"""Attention window length and the prior weights over the audio time axis.

Port of the JAX package's ``data/priors.py``. The window tracks the
BN-Inception temporal output width: a 256x800 spectrogram (4 s of audio)
leaves the tower as an 8x25 feature map, so the anchor is 25/4 positions
per second and ``win = round(audio_length * 25/4)`` (reference core/dataset/dataset.py:534-541, core/models/model.py:60-61).

Three prior families (reference dataset.py:543-575), fed to the model as
``weights`` (``attention.use_fixed``) or to the loss as ``target_weights``
(``attention.use_prior``):

* gaussian: unimodal Gaussian (sigma 1) centred on the window;
* uniform: 1/win everywhere;
* loud: the Gaussian re-centred on the loudest ``win``-sized spectrogram
  block, flattened to its minimum outside +-4 of the mode.
"""

from __future__ import annotations

import numpy as np

ATTENTION_ANCHOR = 25.0 / 4.0


def attention_window_size(audio_length: float) -> int:
    """Temporal length of the post-tower audio feature (and of the priors)."""
    # Python 3 round() is banker's rounding, same as the reference's use.
    return round(audio_length * ATTENTION_ANCHOR)


def gaussian_kernel(ksize: int, sigma: float = 1.0) -> np.ndarray:
    """(ksize, 1) normalized Gaussian equal to
    ``cv2.getGaussianKernel(ksize, sigma)``, without depending on cv2.

    OpenCV samples exp(-x^2 / (2 sigma^2)) at x = i - (ksize-1)/2, except
    that for an EVEN size both centre taps take weight exp(0) = 1 instead of
    their sampled value; the kernel is then normalized to sum 1. (cv2's
    sigma <= 0 defaults have no caller here and are refused.)
    """
    ksize = int(ksize)
    if sigma <= 0:
        raise ValueError(f"sigma must be positive, got {sigma}")
    positions = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    kernel = np.exp(-(positions**2) / (2.0 * sigma**2))
    if ksize % 2 == 0:
        kernel[ksize // 2 - 1 : ksize // 2 + 1] = 1.0
    kernel /= kernel.sum()
    return kernel.reshape(-1, 1)


def gaussian_prior(win_size: int) -> np.ndarray:
    return gaussian_kernel(win_size, sigma=1.0).astype(np.float32)


def uniform_prior(win_size: int) -> np.ndarray:
    return (np.ones((win_size, 1), dtype=np.float32) / win_size).astype(np.float32)


def loud_prior(spec: np.ndarray, win_size: int) -> np.ndarray:
    """The Gaussian prior re-centred on the loudest window of the (freq,
    time) log-power ``spec``: complete ``win_size`` blocks along time,
    loudness the block's max.

    Kept from the reference as it is (dataset.py:560-571): the gate compares
    the loudest BLOCK index against the WINDOW length, so a late loud block
    can leave the prior centred or roll its peak off the end before the
    flattening; priors then match the reference's bit for bit."""
    loudness = np.asarray([np.max(spec[:, idx : idx + win_size])
                           for idx in range(0, spec.shape[1], win_size)
                           if idx + win_size <= spec.shape[1]])
    wts = gaussian_kernel(win_size, sigma=1.0)
    min_val = wts.min()
    mean_loc = wts.shape[0] // 2
    loudest_loc = int(np.argsort(loudness)[-1])
    if loudest_loc <= wts.shape[0] and (loudest_loc < mean_loc - 2 or loudest_loc > mean_loc + 2):
        wts = np.roll(wts, loudest_loc - mean_loc)
        if loudest_loc - 4 > 0:
            wts[: loudest_loc - 4] = min_val
        if loudest_loc + 4 < wts.shape[0]:
            wts[loudest_loc + 4 :] = min_val
    return wts.astype(np.float32)


def attention_prior(prior_type: str, win_size: int, spec: np.ndarray = None) -> np.ndarray:
    """(win_size, 1) float32 prior of ``prior_type``; "loud" needs ``spec``."""
    if prior_type == "gaussian":
        return gaussian_prior(win_size)
    if prior_type == "uniform":
        return uniform_prior(win_size)
    if prior_type == "loud":
        if spec is None:
            raise ValueError("'loud' prior needs the spectrogram")
        return loud_prior(spec, win_size)
    raise ValueError(f"Unknown prior type {prior_type!r}")
