"""The towers' stride-2 ceil max pool: the port's plain version and its
``max_pool2d(impl="pallas")`` dispatch against the JAX package's
reduce-window pool and its Pallas kernel (interpret mode), forward and
gradient; the plain pool-with-taps and tap backward (the twins of the
forward kernel's tap codes and of the gather backward kernel) against the
JAX gradient and torch's NaN routing; the kernel wrapper's CPU rule,
layout and size checks and autograd wiring; the ``tpu.pool_impl`` check of
both packages; and, on a card only, the CUDA kernels against torch.

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
from attention_based_tbn_tpu_torch.models.builder import build_model
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


def _plain_forward_impl(calls):
    """The kernel's forward replaced by the plain twins, recording whether
    taps were asked for."""
    def forward_impl(x, with_taps):
        calls.append(with_taps)
        if with_taps:
            return kernels.ceil_max_pool2d_taps_plain(x)
        return kernels.ceil_max_pool2d_plain(x), None
    return forward_impl


def test_autograd_function_backward_is_the_plain_gradient(monkeypatch):
    """The kernels' autograd wiring, with both kernels replaced by their
    plain twins (the kernels themselves need a card): the forward asks for
    taps only while autograd records through the input, and the tap backward
    gives the plain pool's gradient."""
    calls = []
    monkeypatch.setattr(kernels.CeilMaxPool2d, "forward_impl",
                        staticmethod(_plain_forward_impl(calls)))
    monkeypatch.setattr(kernels.CeilMaxPool2d, "backward_impl",
                        staticmethod(kernels.ceil_max_pool2d_backward_plain))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 28, 28, 8)).astype(np.float32)
    g = rng.standard_normal((2, 14, 14, 8)).astype(np.float32)
    got = _port_pool_and_grad(kernels.CeilMaxPool2d.apply, x, g)
    want = _port_pool_and_grad(kernels.ceil_max_pool2d_plain, x, g)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with torch.no_grad():
        kernels.CeilMaxPool2d.apply(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert calls == [True, False]


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_tap_wiring_keeps_the_layout_and_dtype(monkeypatch, dtype, channels_last):
    """Through the autograd Function (plain twins in place of the kernels)
    the output and dx keep x's memory format and type, with a gradient
    handed in the other memory format, and dx equals torch's gradient."""
    monkeypatch.setattr(kernels.CeilMaxPool2d, "forward_impl",
                        staticmethod(_plain_forward_impl([])))
    monkeypatch.setattr(kernels.CeilMaxPool2d, "backward_impl",
                        staticmethod(kernels.ceil_max_pool2d_backward_plain))
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 15, 12, generator=gen).to(dtype).contiguous(memory_format=fmt)
    xg = x.clone().requires_grad_(True)
    out = kernels.CeilMaxPool2d.apply(xg)
    g = torch.randn(out.shape, generator=gen).to(dtype)  # NCHW whatever x's format
    (dx,) = torch.autograd.grad(out, xg, g)
    assert out.is_contiguous(memory_format=fmt) and dx.is_contiguous(memory_format=fmt)
    assert dx.dtype == dtype
    xf = x.float().requires_grad_(True)
    (want,) = torch.autograd.grad(kernels.ceil_max_pool2d_plain(xf), xf, g.float())
    torch.testing.assert_close(dx, want.to(dtype), rtol=0, atol=0)


# (H, W, C) of the tap tests: a map where a 3 x 3 window fits once and odd
# sizes (7, 13, 105: the audio tower's 105-wide map and its 13 and 7), and
# even ones the Pallas kernel takes (even H, W <= 128)
TAP_SHAPES = [(16, 26, 8), (105, 13, 4), (7, 7, 8), (64, 105, 4)]


def _tap_case(h, w, c, ties, seed):
    rng = np.random.default_rng(seed)
    if ties:  # the tie maps of test_tie_gradient_routes_as_jax
        x = rng.integers(0, 3, (2, h, w, c)).astype(np.float32)
    else:
        x = rng.standard_normal((2, h, w, c)).astype(np.float32)
    g = rng.standard_normal((2, _ceil_out(h, 3, 2), _ceil_out(w, 3, 2), c)).astype(np.float32)
    return x, g


@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("h,w,c", TAP_SHAPES)
def test_taps_and_tap_backward_match_jax(h, w, c, channels_last, dtype, ties):
    """The plain pool-with-taps and the plain tap backward against the JAX
    package's pool and gradient, exactly: jax.vjp of ``_xla_pool`` and, where
    the Pallas kernel takes the shape, of ``ceil_max_pool2d_pallas`` in
    interpret mode. The inputs are exact in bf16; at bf16 the reference is
    the JAX gradient of those values in float32, rounded to bf16 once: the
    port sums a gradient's (at most four) terms in float32 and rounds once,
    as torch's CUDA backward does, where JAX's bf16 VJP rounds every partial
    sum (so inputs that take three or four windows' gradients may differ)."""
    x, g = _tap_case(h, w, c, ties, seed=h * w + c)
    x = x.astype(np.float32)
    if dtype == torch.bfloat16:  # make both sides' inputs bf16-exact
        x = torch.from_numpy(x).bfloat16().float().numpy()
        g = torch.from_numpy(g).bfloat16().float().numpy()
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=fmt)
    out, taps = kernels.ceil_max_pool2d_taps_plain(xt)
    assert out.is_contiguous(memory_format=fmt) and taps.is_contiguous(memory_format=fmt)
    assert taps.dtype == torch.uint8 and int(taps.max()) <= 8
    gt = torch.from_numpy(g).permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=fmt)
    dx = kernels.ceil_max_pool2d_backward_plain(gt, taps, tuple(xt.shape), channels_last)
    assert dx.is_contiguous(memory_format=fmt) and dx.dtype == dtype
    got = (out.float().permute(0, 2, 3, 1).numpy(), dx.float().permute(0, 2, 3, 1).numpy())
    refs = [_xla_pool] + ([lambda v: ceil_max_pool2d_pallas(v, True)]
                          if h % 2 == 0 and w <= 128 else [])
    for fn in refs:
        want = _jax_pool_and_grad(fn, x, g)
        want_dx = torch.from_numpy(want[1].copy()).to(dtype).float().numpy()  # rounded once
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want_dx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
def test_nan_taps_follow_torch(channels_last, dtype):
    """NaN: torch's pool lets a NaN tap win (the last one of a window) and
    sends the window's gradient there; the plain twins do the same. (The JAX
    package's forward also returns NaN, but XLA's select-and-scatter routes
    the gradient of such a window elsewhere: there the port follows torch,
    whose gradient the model trained with before the kernels.)"""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 3, (2, 4, 15, 13)).astype(np.float32)
    x.reshape(-1)[::37] = np.nan
    x.reshape(-1)[1::37] = np.nan
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    xt = torch.from_numpy(x).to(dtype).contiguous(memory_format=fmt)
    out, taps = kernels.ceil_max_pool2d_taps_plain(xt)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32)).to(dtype)
    dx = kernels.ceil_max_pool2d_backward_plain(g, taps, tuple(xt.shape), channels_last)
    xf = xt.float().requires_grad_(True)
    want = torch.nn.functional.max_pool2d(xf, 3, 2, 0, ceil_mode=True)
    (want_dx,) = torch.autograd.grad(want, xf, g.float())
    assert int(want.isnan().sum()) > 0
    torch.testing.assert_close(out.float(), want, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(dx, want_dx.to(dtype), rtol=0, atol=0)


def test_pool_size_limits_are_refused_without_a_card():
    """The kernels' 32-bit index math and grid axes: 2^31 elements, or N or
    H above 65535, are refused before any launch."""
    kernels._check_pool_size(torch.empty(250, 64, 128, 210, device="meta"))
    for shape in ((2**16, 64, 128, 256), (1, 1, 70000, 3), (70000, 1, 3, 3)):
        with pytest.raises(ValueError, match="2\\^31"):
            kernels._check_pool_size(torch.empty(shape, device="meta"))


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


# (kernel, stride, padding, (N, H, W, C)) of the towers' two max pools:
# the stride-2 ceil pool (odd W: a clipped last window) and the stride-1
# pad-1 pool of the inception blocks' pool branch
TIE_POOLS = {"3x3_s2_ceil": (3, 2, 0, (2, 16, 27, 4)), "3x3_s1_p1": (3, 1, 1, (2, 9, 13, 4))}


def _tied_pool_grads(pool, channels_last, fast_vjp):
    """A map of values 0, 1, 2 (exact ties in most windows) and a gradient:
    JAX's input gradient through ``max_pool2d(..., fast_vjp=True)`` (NHWC
    numpy), the port's dx through ``max_pool2d(..., fast_vjp=fast_vjp)``
    on NCHW or channels-last memory, and torch's own pool gradient."""
    from attention_based_tbn_tpu.ops.pooling import max_pool2d as jax_max_pool2d

    k, s, p, shape = TIE_POOLS[pool]
    rng = np.random.default_rng(sum(shape) + s)
    x = rng.integers(0, 3, shape).astype(np.float32)
    y, vjp = jax.vjp(lambda v: jax_max_pool2d(v, k, s, p, True, fast_vjp=True), jnp.asarray(x))
    g = rng.standard_normal(y.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # channels-last memory
    xt = (xt if channels_last else xt.contiguous()).requires_grad_(True)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    out = max_pool2d(xt, k, s, p, ceil_mode=True, fast_vjp=fast_vjp)
    np.testing.assert_array_equal(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y))
    (dx,) = torch.autograd.grad(out, xt, gt)
    (plain,) = torch.autograd.grad(
        torch.nn.functional.max_pool2d(xt, k, s, p, ceil_mode=True), xt, gt)
    return want, dx, plain


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("pool", sorted(TIE_POOLS))
def test_fast_vjp_gradient_matches_jax_on_ties(pool, channels_last):
    """With tpu.pool_fast_vjp every maximal input of a tied window takes
    the window's gradient, exactly JAX's _max_pool_fast_vjp in float32, in
    the input's memory format."""
    want, dx, _ = _tied_pool_grads(pool, channels_last, fast_vjp=True)
    np.testing.assert_array_equal(_nhwc(dx), want)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    assert dx.is_contiguous(memory_format=fmt)


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("pool", sorted(TIE_POOLS))
def test_without_fast_vjp_the_gradient_has_one_winner(pool, channels_last):
    """The key off: torch's single-winner gradient, unchanged, which on
    this map differs from the all-ties one."""
    want, dx, plain = _tied_pool_grads(pool, channels_last, fast_vjp=False)
    torch.testing.assert_close(dx, plain, rtol=0, atol=0)
    assert not np.array_equal(_nhwc(dx), want)


def test_fast_vjp_keeps_the_dispatch_order(monkeypatch):
    """JAX's order: the kernel (pallas on the accelerator), then slices,
    then fast_vjp, then the default. Without autograd, and for slices or
    integer maps, the all-ties Function is not used."""
    from attention_based_tbn_tpu_torch.ops import pooling

    calls = []
    monkeypatch.setattr(pooling.MaxPoolAllTies, "apply",
                        lambda *a: calls.append(a) or torch.nn.functional.max_pool2d(*a[:4]))
    x = torch.randn(1, 2, 9, 9, requires_grad=True)
    max_pool2d(x, 3, 2, 0, True, impl="slices", fast_vjp=True)
    max_pool2d(x.detach(), 3, 2, 0, True, fast_vjp=True)
    max_pool2d(torch.ones(1, 2, 9, 9, dtype=torch.int32), 3, 2, 0, True, fast_vjp=True)
    with torch.no_grad():
        max_pool2d(x, 3, 2, 0, True, fast_vjp=True)
    assert not calls
    for impl in ("reduce_window", "pallas"):  # pallas on a CPU tensor: no kernel
        max_pool2d(x, 3, 2, 0, True, impl=impl, fast_vjp=True)
    assert len(calls) == 2


def test_pool_fast_vjp_is_read_and_reaches_every_max_pool(monkeypatch):
    """TBNSpec reads tpu.pool_fast_vjp as the JAX TBNSpec does, and every
    tower hands it to each of its max pools (the default stays off)."""
    from attention_based_tbn_tpu_torch.models import bn_inception

    cfg, jcfg = configs(["tpu.pool_fast_vjp=true"])
    spec = TBNSpec.from_config(cfg, ("RGB", "Audio"))
    assert spec.pool_fast_vjp and JaxTBNSpec.from_config(jcfg, ("RGB", "Audio")).pool_fast_vjp
    assert not TBNSpec.from_config(configs()[0], ("RGB", "Audio")).pool_fast_vjp
    model = TBNModel(spec)
    towers = [model.Base_RGB, model.Base_Audio]
    assert all(t.pool_fast_vjp for t in towers)
    seen = []
    real = bn_inception.max_pool2d
    monkeypatch.setattr(bn_inception, "max_pool2d",
                        lambda *a, **kw: seen.append(kw["fast_vjp"]) or real(*a, **kw))
    with torch.no_grad():
        towers[0](torch.randn(1, 3, 64, 64), torch.float32)
    # pool1, pool2, the passthroughs of 3c and 4e, and 5b's max branch
    assert len(seen) == 5 and all(seen)


def test_int8_quantize_runs_in_jax_and_is_refused_by_the_port():
    """tpu.quantize=int8 selects int8 towers in both packages at the spec
    level (the port's run on its int8 kernels: tests/test_torch_port_quantize.py);
    the port's drivers refuse the key, as the JAX package's do."""
    cfg, jcfg = configs(["tpu.quantize=int8"])
    JaxTBNSpec.from_config(jcfg, ("RGB", "Audio")).validate()
    spec = TBNSpec.from_config(cfg, ("RGB", "Audio"))
    assert spec.quantize == "int8"
    spec.validate()
    model = TBNModel(spec)
    assert model.Base_RGB.quantize == model.Base_Audio.quantize == "int8"
    with pytest.raises(ValueError, match="calibrate_quantization"):
        build_model(cfg, ["RGB", "Audio"], device="cpu")
    dataclasses.replace(spec, quantize="").validate()


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties_nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
def test_cuda_kernel_equals_plain_on_the_card(dtype, channels_last, ties):
    """Flagship pool shapes at a few rows: forward exactly equal (NaN where
    torch has NaN), output in the input's memory format; the gradient
    through the taps and the gather kernel bit-equal to torch's, in x's
    memory format."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(0)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    for c, h, w in ((64, 112, 112), (192, 56, 56), (64, 128, 210), (608, 16, 26), (3, 9, 7)):
        if ties:
            x = torch.randint(0, 3, (4, c, h, w), generator=gen).float()
            x.view(-1)[::97] = float("nan")
            x.view(-1)[1::97] = float("nan")
        else:
            x = torch.randn(4, c, h, w, generator=gen)
        x = x.cuda().to(dtype).contiguous(memory_format=fmt)
        before = kernels.ceil_max_pool2d.launches
        got = kernels.ceil_max_pool2d(x)
        assert kernels.ceil_max_pool2d.launches == before + 1
        want = kernels.ceil_max_pool2d_plain(x)
        assert got.is_contiguous(memory_format=fmt)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        xg = x.detach().requires_grad_(True)
        g = torch.randn(want.shape, generator=gen).cuda().to(dtype)
        (dx,) = torch.autograd.grad(kernels.ceil_max_pool2d(xg), xg, g)
        (dw,) = torch.autograd.grad(kernels.ceil_max_pool2d_plain(xg), xg, g)
        assert dx.is_contiguous(memory_format=fmt)
        torch.testing.assert_close(dx, dw, rtol=0, atol=0)
