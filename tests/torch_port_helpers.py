"""Shared fixtures of the tests/test_torch_port_*.py files: small configs,
seeded batches, a port model with randomized BatchNorm, and the JAX
package's forward on the same weights (carried by models/bridge.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.config import load_config as jax_load_config
from attention_based_tbn_tpu.models.tbn import TBNModel as JaxTBNModel
from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.utils.misc import get_modality

# 64-px crops, 2 segments, 1.279 s audio (attention window 8), fp32.
SMALL = [
    "data.audio.audio_length=1.279",
    "tpu.compute_dtype=float32",
    "data.test_crop_size=64",
    "test.num_segments=2",
]
AUDIO_LEN = int(1.279 * 24000)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch work on one intra-op thread. The suite runs in
    several pytest-xdist workers on a few cores, and torch's default of one
    thread per core then oversubscribes the host many times over (measured:
    5-30x slower tests)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(overrides=()):
    over = SMALL + list(overrides)
    return load_config(overrides=over), jax_load_config(overrides=over)


@torch.no_grad()
def randomize_batchnorm(model, seed=1):
    """Random BN affine and running statistics and conv biases, so eval
    BatchNorm (folded into the convs) is not the identity."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in model.state_dict().items():
        if not name.startswith("Base_") or name.endswith("num_batches_tracked"):
            continue
        if name.endswith("_bn.weight") or name.endswith("running_var"):
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
        elif name.endswith("bias") or name.endswith("running_mean"):
            t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    return model


def port_model(cfg, seed=0):
    return randomize_batchnorm(build_model(cfg, get_modality(cfg), device="cpu", seed=seed))


def make_batch(cfg, b=2, seed=0, crops=1):
    """numpy inputs in the JAX layouts; ``crops`` multiplies the visual
    segment rows (10-crop eval)."""
    rng = np.random.default_rng(seed)
    modality = get_modality(cfg)
    n = int(cfg.test.num_segments)
    crop = int(cfg.data.test_crop_size)
    batch = {}
    if "RGB" in modality:
        batch["RGB"] = rng.integers(0, 255, (b, n * crops, crop, crop, 3)).astype(np.uint8)
    if "Flow" in modality:
        batch["Flow"] = rng.integers(0, 255, (b, n * crops, crop, crop, 10)).astype(np.uint8)
    if "Audio" in modality:
        batch["Audio"] = (rng.standard_normal((b, n, AUDIO_LEN)) * 0.1).astype(np.float32)
    if cfg.model.attention.use_fixed:
        batch["weights"] = rng.random((b, n, 8, 1)).astype(np.float32)
    return batch


def port_forward(model, batch):
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    return {k: v.float().numpy() for k, v in out.items()}


def assert_outputs_match(got, want):
    """Logits rtol 1e-4 / atol 5e-4, attention weights atol 5e-5 (fp32
    summation order through ~60 conv layers per tower)."""
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert np.isfinite(got[key]).all()
        tol = dict(rtol=1e-4, atol=5e-4) if key != "weights" else dict(rtol=1e-4, atol=5e-5)
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


def jax_forward(jcfg, state_dict, batch):
    spec = JaxTBNSpec.from_config(jcfg, get_modality(jcfg))
    model = JaxTBNModel(spec)
    variables = jax.tree.map(jnp.asarray, state_dict_to_jax(state_dict))
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    return {k: np.asarray(v, np.float32) for k, v in out.items()}
