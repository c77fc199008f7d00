"""Attention window length and the Gaussian kernel of the prototype curves.

The window tracks the BN-Inception temporal output width: a 256x800
spectrogram (4 s of audio) leaves the tower as an 8x25 feature map, so the
anchor is 25/4 positions per second and ``win = round(audio_length * 25/4)``
(reference core/dataset/dataset.py:534-541, core/models/model.py:60-61).
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
