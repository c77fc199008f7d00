"""The port's host and tensor ops against the JAX package: config loading,
priors, the in-forward spectrogram and the torch-semantics pools.

Tolerances: spectrograms atol 1e-4 on the log scale (the DFT sums run in
another order; bf16 mode rounds the operands identically on both sides),
pools 1e-6 (a window of at most 9 fp32 values), everything else exact.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import attention_based_tbn_tpu.ops.pooling  # noqa: F401 (module, not the re-export)
import attention_based_tbn_tpu.ops.spectrogram  # noqa: F401
from attention_based_tbn_tpu.config import load_config as jax_load_config
from attention_based_tbn_tpu.data import priors as jax_priors
from attention_based_tbn_tpu.utils.misc import get_modality as jax_get_modality
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.data import priors
from attention_based_tbn_tpu_torch.ops import pooling, spectrogram
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

J_POOL = sys.modules["attention_based_tbn_tpu.ops.pooling"]
J_SPEC = sys.modules["attention_based_tbn_tpu.ops.spectrogram"]


@pytest.mark.parametrize("overrides", [
    [],
    ["model.attention.type=proto", "data.flow.enable=false", "tpu.compute_dtype=float32"],
    ["data.audio.audio_length=1.279", "model.num_classes={verb: 11, noun: 13}",
     "train.optim.lr=1e-3", "tpu.export_buckets=[1, 10]"],
])
def test_config_matches_jax(overrides):
    cfg, jcfg = load_config(overrides=overrides), jax_load_config(overrides=overrides)
    assert cfg.to_dict() == jcfg.to_dict()
    assert get_modality(cfg) == jax_get_modality(jcfg)


def test_config_override_errors():
    with pytest.raises(ValueError):
        load_config(overrides=["no_equals_sign"])
    with pytest.raises(FileNotFoundError):
        load_config(overrides=["data=missing_group"])


def test_attention_window_size_matches_jax():
    for length in (1.279, 1.28, 2.1, 4.0, 0.5, 3.3):
        assert priors.attention_window_size(length) == jax_priors.attention_window_size(length)
    assert priors.attention_window_size(2.1) == 13
    assert priors.attention_window_size(1.279) == 8


def test_gaussian_kernel_matches_jax_without_cv2():
    """Odd and even sizes (even sizes give both centre taps weight 1)."""
    for ksize in range(1, 26):
        for sigma in (1.0, 0.5, 2.5):
            np.testing.assert_allclose(
                priors.gaussian_kernel(ksize, sigma),
                np.asarray(jax_priors.gaussian_kernel(ksize, sigma), np.float64),
                rtol=1e-12, atol=1e-15,
            )
    with pytest.raises(ValueError):
        priors.gaussian_kernel(5, 0.0)


@pytest.mark.parametrize("seconds,shape", [(2.1, (256, 420)), (1.279, (256, 256))])
def test_log_power_stft_matches_jax(seconds, shape):
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal((3, int(seconds * 24000))) * 0.1).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(J_SPEC.log_power_stft(jnp.asarray(wave), compute_dtype=jdt))
        got = spectrogram.log_power_stft(torch.from_numpy(wave), compute_dtype=tdt).numpy()
        assert got.shape == want.shape == (3,) + shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_log_mel_and_dispatch_match_jax():
    wave = (np.random.default_rng(1).standard_normal((2, 2, 30696)) * 0.1).astype(np.float32)
    want = np.asarray(J_SPEC.spectrogram(jnp.asarray(wave), spec_type="logms"))
    got = spectrogram.spectrogram(torch.from_numpy(wave), spec_type="logms").numpy()
    assert got.shape == want.shape == (2, 2, 128, 256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        spectrogram.spectrogram(torch.from_numpy(wave), spec_type="cqt")


# (H, W) maps of the towers at 64-px crops and of the 2.1 s audio tower
# (210 / 105 / 53 wide), odd and even; pool geometries of BN-Inception plus
# padded ceil-mode ones that exercise the divisor rule.
POOL_SIZES = [(64, 210), (65, 105), (33, 53), (7, 13), (8, 26), (112, 112)]
POOL_GEOMS = [(3, 2, 0), (3, 1, 1), (3, 2, 1), (2, 2, 0), (5, 3, 2)]


@pytest.mark.parametrize("h,w", POOL_SIZES)
def test_pools_match_jax(h, w):
    rng = np.random.default_rng(h * w)
    x = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    for arr in (x, np.ones_like(x)):  # ones expose the avg divisor directly
        xt = torch.from_numpy(arr).permute(0, 3, 1, 2)
        for k, s, p in POOL_GEOMS:
            want_avg = np.asarray(J_POOL.avg_pool2d(jnp.asarray(arr), k, s, p, ceil_mode=True,
                                                    count_include_pad=True))
            got_avg = pooling.avg_pool2d(xt, k, s, p, ceil_mode=True, count_include_pad=True)
            want_max = np.asarray(J_POOL.max_pool2d(jnp.asarray(arr), k, s, p, ceil_mode=True))
            got_max = pooling.max_pool2d(xt, k, s, p, ceil_mode=True)
            np.testing.assert_allclose(got_avg.permute(0, 2, 3, 1).numpy(), want_avg,
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(got_max.permute(0, 2, 3, 1).numpy(), want_max)


@pytest.mark.parametrize("freq_only", [False, True])
def test_global_avg_pool_matches_jax(freq_only):
    x = np.random.default_rng(2).standard_normal((3, 8, 13, 16)).astype(np.float32)
    want = np.asarray(J_POOL.global_avg_pool(jnp.asarray(x), freq_only=freq_only))
    got = pooling.global_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), freq_only=freq_only)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
