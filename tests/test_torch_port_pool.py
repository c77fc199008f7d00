"""The towers' stride-2 ceil max pool: the port's plain version and its
``max_pool2d(impl="pallas")`` dispatch against the JAX package's
reduce-window pool and its Pallas kernel (interpret mode), forward and
gradient; the kernel wrapper's CPU rule, layout checks and autograd
wiring; the ``tpu.pool_impl`` check of both packages; and, on a card only,
the CUDA kernel against its plain version.

Tolerance: none. Max is exact, and the gradient of a max pool routes each
output's gradient to one input, so every comparison is exact equality
(inputs are continuous float32, where ties have probability ~0; one test
makes ties on purpose).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu.ops.pallas_pool import _ceil_out, _xla_pool, ceil_max_pool2d_pallas
from attention_based_tbn_tpu_torch.models.tbn import TBNModel, TBNSpec
from attention_based_tbn_tpu_torch.ops import kernels
from attention_based_tbn_tpu_torch.ops.pooling import POOL_IMPLS, max_pool2d
from torch_port_helpers import configs, one_torch_thread  # noqa: F401 (autouse fixture)

# (H, W, C): the JAX package's Pallas-pool test shapes plus the audio
# tower's 210- and 105-wide maps
SHAPES = [(112, 112, 8), (64, 105, 16), (16, 26, 8), (28, 28, 16), (32, 53, 8),
          (128, 210, 4), (64, 105, 4)]


def _jax_pool_and_grad(fn, x_nhwc, g_nhwc):
    y, vjp = jax.vjp(fn, jnp.asarray(x_nhwc))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g_nhwc))[0])


def _port_pool_and_grad(fn, x_nhwc, g_nhwc):
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    y = fn(x)
    y.backward(torch.from_numpy(g_nhwc).permute(0, 3, 1, 2))
    return y.detach().permute(0, 2, 3, 1).numpy(), x.grad.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("h,w,c", SHAPES)
def test_plain_and_dispatch_match_jax(h, w, c):
    rng = np.random.default_rng(h * w + c)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    g = rng.standard_normal((2, _ceil_out(h, 3, 2), _ceil_out(w, 3, 2), c)).astype(np.float32)
    want = _jax_pool_and_grad(_xla_pool, x, g)
    pallas = _jax_pool_and_grad(lambda v: ceil_max_pool2d_pallas(v, True), x, g)
    plain = _port_pool_and_grad(kernels.ceil_max_pool2d_plain, x, g)
    dispatched = _port_pool_and_grad(lambda v: max_pool2d(v, 3, 2, 0, True, impl="pallas"), x, g)
    for got in (pallas, plain, dispatched):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_tie_gradient_routes_as_jax():
    """A map of few distinct values, so windows hold exact ties: torch
    sends a window's gradient to its first maximal tap in row-major order,
    and XLA's select-and-scatter (select ``>=``) to the same tap."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 3, (2, 16, 26, 4)).astype(np.float32)
    g = rng.standard_normal((2, 8, 13, 4)).astype(np.float32)
    want = _jax_pool_and_grad(_xla_pool, x, g)
    got = _port_pool_and_grad(kernels.ceil_max_pool2d_plain, x, g)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_ceil_out_size_matches_jax():
    for size in range(3, 300):
        assert kernels.ceil_out_size(size) == _ceil_out(size, 3, 2), size
    assert [kernels.ceil_out_size(s) for s in (112, 210, 105, 56, 14)] == [56, 105, 52, 28, 7]


def test_autograd_function_backward_is_the_plain_gradient(monkeypatch):
    """The kernel's autograd wiring, with the kernel's forward replaced by the
    plain pool (the kernel itself needs a card): the backward must give the
    plain pool's gradient."""
    monkeypatch.setattr(kernels.CeilMaxPool2d, "forward_impl",
                        staticmethod(kernels.ceil_max_pool2d_plain))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 28, 28, 8)).astype(np.float32)
    g = rng.standard_normal((2, 14, 14, 8)).astype(np.float32)
    got = _port_pool_and_grad(kernels.CeilMaxPool2d.apply, x, g)
    want = _port_pool_and_grad(kernels.ceil_max_pool2d_plain, x, g)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_cpu_tensors_take_the_plain_pool():
    kernels.reset_launch_counts()
    x = torch.randn(2, 8, 28, 28, generator=torch.Generator().manual_seed(0))
    for impl in POOL_IMPLS:
        torch.testing.assert_close(max_pool2d(x, 3, 2, 0, True, impl=impl),
                                   kernels.ceil_max_pool2d_plain(x), rtol=0, atol=0)
    torch.testing.assert_close(kernels.ceil_max_pool2d(x), kernels.ceil_max_pool2d_plain(x),
                               rtol=0, atol=0)
    assert kernels.ceil_max_pool2d.launches == 0


def test_layout_rule():
    """NCHW and channels-last are taken without a copy; any other stride
    pattern, dtype, rank or a map under 3 wide is refused."""
    x = torch.zeros(2, 8, 12, 10)
    assert kernels.pool_layout(x) is False
    assert kernels.pool_layout(x.to(memory_format=torch.channels_last)) is True
    assert kernels.pool_layout(x.to(torch.bfloat16)) is False
    with pytest.raises(ValueError, match="strides"):
        kernels.pool_layout(x.transpose(2, 3))
    with pytest.raises(ValueError, match="dtype"):
        kernels.pool_layout(x.double())
    with pytest.raises(ValueError, match=">= 3"):
        kernels.pool_layout(torch.zeros(2, 8, 2, 10))
    with pytest.raises(ValueError, match="N, C, H, W"):
        kernels.pool_layout(torch.zeros(8, 12, 10))


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.ceil_max_pool2d(torch.zeros(2, 8, 12, 10, device="meta"))


def test_bogus_pool_impl_raises_in_both_packages():
    cfg, jcfg = configs(["tpu.pool_impl=bogus"])
    spec = TBNSpec.from_config(cfg, ("RGB", "Audio"))
    assert spec.pool_impl == "bogus"
    with pytest.raises(ValueError, match="pool_impl"):
        TBNModel(spec)
    with pytest.raises(ValueError, match="pool_impl"):
        JaxTBNSpec.from_config(jcfg, ("RGB", "Audio")).validate()
    for impl in POOL_IMPLS:  # the three JAX values parse in the port
        dataclasses.replace(spec, pool_impl=impl).validate()


def test_int8_quantize_runs_in_jax_and_is_refused_by_the_port():
    """tpu.quantize=int8 selects int8 towers in the JAX package; the port has
    none yet and refuses the key instead of returning bf16 logits under it."""
    cfg, jcfg = configs(["tpu.quantize=int8"])
    JaxTBNSpec.from_config(jcfg, ("RGB", "Audio")).validate()
    spec = TBNSpec.from_config(cfg, ("RGB", "Audio"))
    assert spec.quantize == "int8"
    with pytest.raises(ValueError, match="quantize"):
        TBNModel(spec)
    dataclasses.replace(spec, quantize="").validate()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_cuda_kernel_equals_plain_on_the_card(dtype, channels_last):
    """Flagship pool shapes at a few rows: forward exactly equal, output in
    the input's memory format, fp32 gradient exactly equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    for c, h, w in ((64, 112, 112), (192, 56, 56), (64, 128, 210), (608, 16, 26), (3, 9, 7)):
        x = torch.randn(4, c, h, w, generator=gen).cuda().to(dtype).contiguous(memory_format=fmt)
        before = kernels.ceil_max_pool2d.launches
        got = kernels.ceil_max_pool2d(x)
        assert kernels.ceil_max_pool2d.launches == before + 1
        want = kernels.ceil_max_pool2d_plain(x)
        assert got.is_contiguous(memory_format=fmt)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        if dtype == torch.float32:
            xg = x.detach().requires_grad_(True)
            g = torch.randn(want.shape, generator=gen).cuda()
            (dx,) = torch.autograd.grad(kernels.ceil_max_pool2d(xg), xg, g)
            (dw,) = torch.autograd.grad(kernels.ceil_max_pool2d_plain(xg), xg, g)
            torch.testing.assert_close(dx, dw, rtol=0, atol=0)
