"""BN-Inception towers of the port against the Flax towers of the JAX
package, eval mode, full channel widths at 64-px crops, with the weights
carried between the two by the port's weight bridge (models/bridge.py).

BatchNorm parameters and running statistics are randomized so that the
port's conv+BN folding is exercised. Tolerance: fp32 rtol 1e-4 and atol
1e-4 times the largest feature (features of random ~60-layer towers reach
O(100); the convolutions sum in another order, and the JAX side runs exact
rewrites — the column-packed stem, merged 1x1 convolutions — of the same
math).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.models.bn_inception import BNInception as JaxBNInception
from attention_based_tbn_tpu.models.layers import ConvBN as JaxConvBN
from attention_based_tbn_tpu_torch.models.bn_inception import BNInception
from attention_based_tbn_tpu_torch.models.bridge import jax_to_state_dict, state_dict_to_jax
from attention_based_tbn_tpu_torch.models.tbn import TBNSpec
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
RGB_MEAN = np.array([0.408, 0.459, 0.502], np.float32)


def _randomize(variables, seed):
    """Random conv biases, BN affine and BN running statistics (Flax tree)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name == "bias":
            return x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def assert_close_scaled(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()))


@torch.no_grad()
def _randomize_port(tower, seed):
    """The same randomization on a port tower's state dict."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in tower.state_dict().items():
        if name.endswith("num_batches_tracked") or (
            name.endswith(".weight") and "_bn" not in name
        ):
            continue
        if name.endswith("_bn.weight") or name.endswith("running_var"):
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
        else:  # conv / BN biases, running means
            t.copy_(torch.randn(t.shape, generator=gen) * 0.1)


@pytest.mark.parametrize("kind", ["rgb_uint8", "flow", "audio_freq_pool", "audio_stem"])
def test_tower_features_match_flax(kind):
    rng = np.random.default_rng(0)
    scale = offset = None
    kw = {}
    if kind == "rgb_uint8":
        x = rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
        scale = np.full(3, 1 / 255.0, np.float32)
        offset = -RGB_MEAN
    elif kind == "flow":
        x = rng.standard_normal((2, 64, 64, 10)).astype(np.float32)
    else:  # a spectrogram patch: 64 frequency bins x 100 frames
        x = rng.standard_normal((2, 64, 100, 1)).astype(np.float32)
        kw = dict(freq_pool_only=True, audio_stem=(kind == "audio_stem"))
    tower = BNInception(x.shape[-1], **kw).eval()
    tower.reset_parameters(torch.Generator().manual_seed(0))
    _randomize_port(tower, seed=1)
    with torch.no_grad():
        got = tower(
            _nchw(x), torch.float32,
            None if scale is None else torch.from_numpy(scale),
            None if offset is None else torch.from_numpy(offset),
        ).numpy()

    variables = state_dict_to_jax({f"Base_X.{k}": v for k, v in tower.state_dict().items()})
    variables = {k: v["Base_X"] for k, v in variables.items()}
    jax_tower = JaxBNInception(**kw)
    jscale = None if scale is None else jnp.asarray(scale)
    joffset = None if offset is None else jnp.asarray(offset)
    want = np.asarray(jax.jit(
        lambda v, a: jax_tower.apply(v, a, False, None, jscale, joffset)
    )(variables, jnp.asarray(x)))
    expected_shape = (2, 3, 1024) if kw else (2, 1024)  # 100 frames -> 3 steps
    assert got.shape == want.shape == expected_shape
    assert_close_scaled(got, want)


def test_stem_matches_flax_packed_stem():
    """The 7x7/2/p3 stem conv + BN + ReLU on a normalized uint8 image
    against the JAX package's column-packed stem (an exact rewrite);
    normalization comes before the conv's zero padding on both sides."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    scale, offset = np.full(3, 1 / 255.0, np.float32), -RGB_MEAN
    stem = JaxConvBN(64, 7, 2, 3, space_to_depth=True)
    kw = dict(input_scale=jnp.asarray(scale), input_offset=jnp.asarray(offset))
    variables = stem.init(jax.random.key(0), jnp.asarray(x), **kw)
    variables = _randomize(variables, seed=4)
    want = np.asarray(stem.apply(variables, jnp.asarray(x), **kw))

    tower = BNInception(3).eval()
    sd = jax_to_state_dict(
        {"params": {"Base_X": {"conv1_7x7_s2": variables["params"]}},
         "batch_stats": {"Base_X": {"conv1_7x7_s2": variables["batch_stats"]}}},
        TBNSpec(),
    )
    missing = tower.load_state_dict(
        {k[len("Base_X."):]: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        strict=False,
    ).missing_keys
    assert not any(k.startswith("conv1_7x7_s2") for k in missing)
    xt = _nchw(x).float() * torch.from_numpy(scale)[:, None, None]
    xt = xt + torch.from_numpy(offset)[:, None, None]
    with torch.no_grad():
        got = tower._cbr("conv1_7x7_s2", xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 32, 32, 64)
    np.testing.assert_allclose(got, want, **TOL)


def test_fold_cache_follows_weight_updates():
    """A reloaded state dict or a dtype change refolds (no stale kernels)."""
    tower = BNInception(3).eval()
    tower.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before = tower(x, torch.float32)
        tower.conv1_7x7_s2_bn.running_var.mul_(4.0)
        after = tower(x, torch.float32)
        bf16 = tower(x, torch.bfloat16)
    assert not torch.allclose(before, after)
    assert bf16.dtype == torch.bfloat16
