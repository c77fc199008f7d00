"""The fused eval stem (tpu.fused_stem): the port's plain version against
the JAX package's jnp reference and its Pallas kernel (interpret mode); the
port tower with the fused stem against the JAX tower with it; the gate
(eval only, 7x7 stem only, H and W multiples of 4); and, on a card only,
the CUDA kernel against its plain version.

Tolerance: fp32 rtol / atol 1e-5 for the stem alone (one 7x7 conv summed
in another order); towers as tests/test_torch_port_towers.py (rtol 1e-4,
atol 1e-4 times the largest feature, ~60 layers).
"""

import numpy as np
import pytest
import torch

import torch.nn.functional as F

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.models.bn_inception import BNInception as JaxBNInception
from attention_based_tbn_tpu.ops.fused_stem import (
    _pack_kernel,
    fused_stem_pallas,
    fused_stem_reference,
)
from attention_based_tbn_tpu_torch.models.bn_inception import BNInception
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.models.tbn import TBNModel, TBNSpec
from attention_based_tbn_tpu_torch.ops import kernels
from test_torch_port_towers import RGB_MEAN, _nchw, _randomize_port, assert_close_scaled
from torch_port_helpers import configs, one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-5)


def _stem_case(c, uint8, seed, h=16, w=20):
    rng = np.random.default_rng(seed)
    if uint8:
        x = rng.integers(0, 255, (2, h, w, c)).astype(np.uint8)
        scale = np.full(c, 1 / 255.0, np.float32)
        offset = -rng.uniform(0.3, 0.6, c).astype(np.float32)
    else:  # a float input (the spectrogram) takes no affine: ones and zeros
        x = rng.standard_normal((2, h, w, c)).astype(np.float32)
        scale, offset = np.ones(c, np.float32), np.zeros(c, np.float32)
    kernel = (rng.standard_normal((7, 7, c, 64)) * 0.05).astype(np.float32)  # HWIO
    bias = (rng.standard_normal(64) * 0.1).astype(np.float32)
    return x, kernel, bias, scale, offset


def _port_stem(fn, x, kernel, bias, scale, offset, dtype=torch.float32):
    weight = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    out = fn(torch.from_numpy(x), weight.to(dtype), torch.from_numpy(bias),
             torch.from_numpy(scale), torch.from_numpy(offset), dtype)
    return out.float().permute(0, 2, 3, 1).numpy()  # NHWC like the JAX side


@pytest.mark.parametrize("c", [3, 10, 1])
@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float"])
def test_plain_matches_jax_reference_and_pallas(c, uint8):
    x, kernel, bias, scale, offset = _stem_case(c, uint8, seed=c)
    args = tuple(jnp.asarray(a) for a in (x, kernel, bias, scale, offset))
    want = np.asarray(fused_stem_reference(*args))
    pallas = np.asarray(fused_stem_pallas(
        args[0], jnp.asarray(_pack_kernel(kernel)), *args[2:], dtype=jnp.float32,
        interpret=True))
    got = _port_stem(kernels.fused_stem_plain, x, kernel, bias, scale, offset)
    assert got.shape == want.shape == (2, 4, 5, 64)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_plain_bf16_matches_jax_reference():
    """At bf16 both normalize and round in the compute type; the conv sums
    in float32 and rounds once: equal up to one bf16 rounding."""
    x, kernel, bias, scale, offset = _stem_case(3, True, seed=7)
    args = tuple(jnp.asarray(a) for a in (x, kernel, bias, scale, offset))
    want = np.asarray(fused_stem_reference(*args, dtype=jnp.bfloat16), np.float32)
    got = _port_stem(kernels.fused_stem_plain, x, kernel, bias, scale, offset, torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("c,k", [(3, 160), (10, 496), (1, 64)])
def test_packed_weight_times_im2col_is_the_conv(c, k):
    """The bf16 kernel's B operand: K order (ky, kx, c), zeros from 49 C up
    to K (a multiple of 16). An im2col of the input in that order (F.unfold
    regrouped, zero rows appended) times the packed weight is F.conv2d."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.standard_normal((2, c, 20, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, c, 7, 7)).astype(np.float32))
    packed = kernels.pack_stem_weight(w)
    assert kernels.stem_k_padded(c) == k
    assert packed.shape == (64, k) and packed.is_contiguous()
    assert not packed[:, 49 * c:].any()
    cols = F.unfold(x, 7, padding=3, stride=2)  # (B, C * 49, L): k = c * 49 + tap
    cols = cols.view(2, c, 49, -1).transpose(1, 2).reshape(2, 49 * c, -1)
    cols = F.pad(cols, (0, 0, 0, k - 49 * c))
    got = (packed @ cols).view(2, 64, 10, 12)
    torch.testing.assert_close(got, F.conv2d(x, w, None, 2, 3), rtol=1e-4, atol=1e-4)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x, kernel, bias, scale, offset = _stem_case(10, True, seed=1)
    before = kernels.fused_stem.launches
    got = _port_stem(kernels.fused_stem, x, kernel, bias, scale, offset)
    want = _port_stem(kernels.fused_stem_plain, x, kernel, bias, scale, offset)
    np.testing.assert_array_equal(got, want)
    assert kernels.fused_stem.launches == before  # a launch counts on the card only


@pytest.mark.parametrize("shape,dtype,problem", [
    ((2, 30, 32, 3), torch.uint8, "multiples of 4"),
    ((2, 32, 34, 3), torch.uint8, "multiples of 4"),
    ((32, 32, 3), torch.uint8, "(B, H, W, C)"),
    ((2, 32, 32, 3), torch.int32, "input dtype"),
])
def test_shapes_outside_the_gate_are_refused(shape, dtype, problem):
    assert problem in kernels.fused_stem_shape_error(torch.zeros(shape, dtype=dtype))
    assert kernels.fused_stem_shape_error(torch.zeros((2, 32, 36, 10), dtype=torch.uint8)) == ""


def _towers(seed=0, **kw):
    """A port tower with randomized BatchNorm, and the same tower in JAX
    with the fused stem in interpret mode, on the same weights."""
    tower = BNInception(3, fused_stem=True, **kw).eval()
    tower.reset_parameters(torch.Generator().manual_seed(seed))
    _randomize_port(tower, seed=seed + 1)
    variables = state_dict_to_jax({f"Base_X.{k}": v for k, v in tower.state_dict().items()})
    variables = {k: v["Base_X"] for k, v in variables.items()}
    return tower, variables


def test_tower_with_fused_stem_matches_jax_fused_tower():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 255, (1, 32, 32, 3)).astype(np.uint8)
    scale, offset = np.full(3, 1 / 255.0, np.float32), -RGB_MEAN
    tower, variables = _towers()
    assert tower.uses_fused_stem(_nchw(x))
    with torch.no_grad():
        got = tower(_nchw(x), torch.float32, torch.from_numpy(scale),
                    torch.from_numpy(offset)).numpy()
    jax_tower = JaxBNInception(fused_stem=True, fused_stem_interpret=True)
    want = np.asarray(jax.jit(lambda v, a: jax_tower.apply(
        v, a, False, None, jnp.asarray(scale), jnp.asarray(offset)))(variables, jnp.asarray(x)))
    assert got.shape == want.shape == (1, 1024)
    assert_close_scaled(got, want)


def test_tower_train_forward_is_unchanged():
    """Training keeps the regular stem and pool1: the same output and the
    same running statistics with and without tpu.fused_stem."""
    rng = np.random.default_rng(5)
    x = _nchw(rng.integers(0, 255, (3, 32, 32, 3)).astype(np.uint8))
    scale, offset = torch.full((3,), 1 / 255.0), -torch.from_numpy(RGB_MEAN)
    fused, _ = _towers(seed=2)
    plain = BNInception(3).train()
    plain.load_state_dict(fused.state_dict())
    fused.train()
    assert not fused.uses_fused_stem(x)
    got = fused(x, torch.float32, scale, offset)
    want = plain(x, torch.float32, scale, offset)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for (name, a), (_, b) in zip(fused.state_dict().items(), plain.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_gate_leaves_audio_stem_and_odd_sizes_to_the_regular_stem():
    audio = BNInception(1, audio_stem=True, fused_stem=True).eval()
    assert not audio.uses_fused_stem(torch.zeros(1, 1, 32, 32))
    tower = BNInception(3, fused_stem=True).eval()
    assert tower.uses_fused_stem(torch.zeros(1, 3, 32, 36))
    assert not tower.uses_fused_stem(torch.zeros(1, 3, 32, 34))
    assert not BNInception(3).eval().uses_fused_stem(torch.zeros(1, 3, 32, 32))


def test_spec_reads_tpu_fused_stem():
    cfg, _ = configs(["tpu.fused_stem=true"])
    spec = TBNSpec.from_config(cfg, ("RGB", "Flow", "Audio"))
    assert spec.fused_stem
    model = TBNModel(spec)
    assert all(getattr(model, f"Base_{m}").fused_stem for m in spec.modality)
    assert not TBNSpec.from_config(configs()[0], ("RGB",)).fused_stem


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_on_the_card(dtype):
    """RGB 224x224, Flow at the flagship 224x224 x 10 and a smaller frame,
    and the 256x420 audio spectrogram; at bf16 the wgmma implicit GEMM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    cases = ((3, True, (224, 224)), (10, True, (224, 224)), (10, True, (64, 96)),
             (1, False, (256, 420)))
    for c, uint8, (h, w) in cases:
        x, kernel, bias, scale, offset = _stem_case(c, uint8, seed=c, h=h, w=w)
        weight = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        args = [torch.from_numpy(a).cuda() for a in (x, bias, scale, offset)]
        args.insert(1, weight.cuda().to(dtype))
        before = kernels.fused_stem.launches
        got = kernels.fused_stem(*args, dtype)
        assert kernels.fused_stem.launches == before + 1
        assert got.is_contiguous(memory_format=torch.channels_last)
        want = kernels.fused_stem_plain(*args, dtype)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol * want.float().abs().max().item())
