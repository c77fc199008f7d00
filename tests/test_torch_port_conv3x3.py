"""The fused-block probe's 3x3 / stride-1 / pad-1 conv + bias + ReLU: the
port's plain version against the JAX probe's Pallas kernel (interpret mode)
and its XLA twin on the same numbers, the weight bridge, the bf16 kernel's
packed operand, the wrapper's CPU rule and the limits it checks without a
card, the port's probe entry point on the CPU, and, on a card only, the
CUDA kernel against its plain version.

Tolerances: float32 within 1e-5 x max |y|: the two sides differ only in the
summation order of 9 C_in <= 288 products. bfloat16: >= 99% of outputs
bit-equal and the gap at most one bf16 ulp of max |y|: both sides sum the
same bf16 products in float32, in other orders, and round once.
"""

import functools
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax.experimental import pallas as pl

from attention_based_tbn_tpu_torch.models.bridge import (
    conv3x3_weight_from_jax,
    conv3x3_weight_to_jax,
)
from attention_based_tbn_tpu_torch.ops import kernels
from attention_based_tbn_tpu_torch.tools import fused_block_probe
from test_torch_port_bf16_params import assert_bf16_match
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, H, W, C_in, C_out)
CASES = [(2, 6, 7, 16, 8), (1, 4, 4, 32, 64), (3, 7, 7, 16, 64), (2, 7, 7, 32, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FP32_RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_probe():
    """``benchmarks/fused_block_probe.py`` loaded by its path, with its
    ``pl`` swapped, in this module object only, for a namespace whose
    ``pallas_call`` runs in interpret mode (no file is edited)."""
    spec = importlib.util.spec_from_file_location(
        "jax_fused_block_probe", os.path.join(REPO, "benchmarks", "fused_block_probe.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    names = {k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")}
    names["pallas_call"] = functools.partial(pl.pallas_call, interpret=True)
    module.pl = types.SimpleNamespace(**names)
    return module


def _inputs(b, h, w, c, n, seed):
    """float32 x (B, H, W, C), HWIO kernel / sqrt(9 C) and bias, as the
    probe draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, c, n)) / np.sqrt(9 * c)).astype(np.float32)
    return x, kernel, rng.standard_normal(n).astype(np.float32)


def _port(x, kernel, bias, dtype=torch.float32):
    """The same numbers as the port's (x, torch-layout weight, bias)."""
    weight = torch.from_numpy(conv3x3_weight_from_jax(kernel))
    return torch.from_numpy(x).to(dtype), weight.to(dtype), torch.from_numpy(bias).to(dtype)


def _assert_fp32_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FP32_RTOL * np.abs(want).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_pallas(jax_probe, case, dtype):
    jdt, tdt = DTYPES[dtype]
    x, kernel, bias = _inputs(*case, seed=sum(case))
    want = np.asarray(jax_probe.conv3x3_pallas(
        jnp.asarray(x, jdt), jnp.asarray(kernel, jdt), jnp.asarray(bias, jdt)), np.float32)
    got = kernels.conv3x3_plain(*_port(x, kernel, bias, tdt))
    assert got.dtype == tdt and got.is_contiguous()
    got = got.float().numpy()
    if tdt == torch.float32:
        _assert_fp32_close(got, want)
    else:
        assert_bf16_match(got, want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_xla_at_fp32(jax_probe, case):
    x, kernel, bias = _inputs(*case, seed=sum(case) + 1)
    want = jax_probe.conv3x3_xla(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    _assert_fp32_close(kernels.conv3x3_plain(*_port(x, kernel, bias)).numpy(), want)


def test_weight_bridge_round_trip():
    rng = np.random.default_rng(3)
    kernel = rng.standard_normal((3, 3, 16, 24)).astype(np.float32)
    weight = conv3x3_weight_from_jax(kernel)
    assert weight.shape == (24, 16, 3, 3) and weight.flags["C_CONTIGUOUS"]
    assert weight[5, 7, 2, 1] == kernel[2, 1, 7, 5]
    np.testing.assert_array_equal(conv3x3_weight_to_jax(weight), kernel)
    np.testing.assert_array_equal(conv3x3_weight_to_jax(torch.from_numpy(weight)), kernel)
    with pytest.raises(ValueError, match="HWIO"):
        conv3x3_weight_from_jax(kernel[:2])
    with pytest.raises(ValueError, match="C_out, C_in, 3, 3"):
        conv3x3_weight_to_jax(kernel)


def test_packed_weight_is_the_conv():
    """[im2col rows in (ky, kx, c) order, zero-padded to K] @ packed.T is
    the conv: the bf16 kernel's two operands, with zeros past 9 C_in and in
    the rows past C_out."""
    x, kernel, bias = _inputs(2, 5, 6, 24, 40, seed=4)
    tx, weight, tb = _port(x, kernel, bias)
    packed = kernels.pack_conv3x3_weight(weight)
    assert packed.shape == (64, kernels.conv3x3_k_padded(24)) == (64, 256)
    assert not packed[40:].any() and not packed[:, 9 * 24:].any()
    xp = F.pad(tx, (0, 0, 1, 1, 1, 1))
    rows = torch.stack([xp[:, ky:ky + 5, kx:kx + 6] for ky in range(3) for kx in range(3)], 3)
    rows = F.pad(rows.reshape(2 * 5 * 6, 9 * 24), (0, packed.shape[1] - 9 * 24))
    y = F.relu((rows @ packed.T)[:, :40] + tb).reshape(2, 5, 6, 40)
    _assert_fp32_close(y.numpy(), kernels.conv3x3_plain(tx, weight, tb).numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version(dtype):
    x, weight, bias = _port(*_inputs(2, 6, 7, 16, 8, seed=5), dtype)
    before = kernels.conv3x3.launches
    got = kernels.conv3x3(x, weight, bias)
    assert kernels.conv3x3.launches == before
    assert got.shape == (2, 6, 7, 8) and got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got, kernels.conv3x3_plain(x, weight, bias), rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.conv3x3(x, torch.zeros(8, 8, 3, 3, device="meta"), torch.zeros(8, device="meta"))


BF16 = torch.bfloat16


def _bf16(*shape):
    return torch.zeros(*shape, dtype=BF16)


LIMIT_CASES = {
    "three_dims": ((_bf16(4, 4, 8), _bf16(8, 8, 3, 3), _bf16(8)), "NHWC"),
    "int_input": ((torch.zeros(1, 4, 4, 8, dtype=torch.int32), _bf16(8, 8, 3, 3), _bf16(8)),
                  "dtype"),
    "empty": ((_bf16(0, 4, 4, 8), _bf16(8, 8, 3, 3), _bf16(8)), "empty"),
    "weight_shape": ((_bf16(1, 4, 4, 8), _bf16(8, 8, 5, 5), _bf16(8)), "weight"),
    "weight_dtype": ((_bf16(1, 4, 4, 8), torch.zeros(8, 8, 3, 3), _bf16(8)), "weight must be"),
    "bias_shape": ((_bf16(1, 4, 4, 8), _bf16(8, 8, 3, 3), _bf16(4)), "bias"),
    "bf16_c_in": ((_bf16(1, 4, 4, 12), _bf16(8, 12, 3, 3), _bf16(8)), "multiples of 8"),
    "bf16_c_out": ((_bf16(1, 4, 4, 8), _bf16(12, 8, 3, 3), _bf16(12)), "multiples of 8"),
    "not_contiguous": ((_bf16(1, 8, 4, 4).permute(0, 2, 3, 1), _bf16(8, 8, 3, 3), _bf16(8)),
                       "contiguous"),
}


@pytest.mark.parametrize("case", sorted(LIMIT_CASES))
def test_limits_refused_without_a_card(case):
    args, message = LIMIT_CASES[case]
    assert message in kernels.conv3x3_shape_error(*args)


def test_limits_accepted_without_a_card():
    assert kernels.conv3x3_shape_error(_bf16(1, 13, 17, 24), _bf16(40, 24, 3, 3),
                                       torch.zeros(40)) == ""
    # the fp32 route takes any channel counts
    assert kernels.conv3x3_shape_error(torch.zeros(1, 5, 5, 3), torch.zeros(5, 3, 3, 3),
                                       torch.zeros(5)) == ""
    assert kernels.CONV3X3_LIMITS[torch.float32] == (1, 1)


def test_operands_are_made_once_per_version():
    weight, bias = _bf16(40, 24, 3, 3).normal_(), _bf16(40).normal_()
    packed, bias32 = kernels.conv3x3_operands(weight, bias)
    assert packed.shape == (64, 256) and bias32.dtype == torch.float32
    torch.testing.assert_close(packed, kernels.pack_conv3x3_weight(weight), rtol=0, atol=0)
    assert kernels.conv3x3_operands(weight, bias)[0] is packed
    with torch.no_grad():
        weight.mul_(2)
    again, _ = kernels.conv3x3_operands(weight, bias)
    assert again is not packed
    torch.testing.assert_close(again, kernels.pack_conv3x3_weight(weight), rtol=0, atol=0)
    w32 = torch.randn(5, 3, 3, 3)
    assert kernels.conv3x3_operands(w32, torch.zeros(5))[0] is w32


def test_probe_draws_the_jax_probes_numbers():
    """x, then the HWIO kernel / sqrt(9 Cin), then the bias from
    default_rng(0), rounded to bf16 as the JAX probe's jnp.asarray rounds
    them: both probes see the same numbers."""
    x, weight, bias = fused_block_probe.probe_inputs(4, 5, 16, 8, BF16, "cpu")
    rng = np.random.default_rng(0)
    jx = jnp.asarray(rng.standard_normal((fused_block_probe.BATCH, 4, 5, 16)), jnp.bfloat16)
    jk = jnp.asarray(rng.standard_normal((3, 3, 16, 8)) / np.sqrt(9 * 16), jnp.bfloat16)
    jb = jnp.asarray(rng.standard_normal(8), jnp.bfloat16)
    np.testing.assert_array_equal(x.float().numpy(), np.asarray(jx, np.float32))
    np.testing.assert_array_equal(conv3x3_weight_to_jax(weight), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(bias.float().numpy(), np.asarray(jb, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_probe_main_on_the_cpu(capsys, dtype):
    result = fused_block_probe.main(["4", "5", "16", "8", "--device", "cpu", "--dtype", dtype])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result
    assert result["shape"] == [4, 5, 16, 8] and result["device"] == "cpu"
    assert result["flops"] == 2 * 200 * 4 * 5 * 9 * 16 * 8
    assert result["rel_err_vs_plain"] == 0.0  # on the CPU the wrapper runs the plain version
    assert result["rel_err_vs_library"] <= (FP32_RTOL if dtype == "float32" else 2.0 ** -7)
    assert result["conv3x3"]["ms"] is None and result["library"]["graph_ms"] is None


def test_probe_defaults_to_the_card():
    args = fused_block_probe.parse_args([])
    assert args.device == "cuda" and args.dtype == "bfloat16" and not args.shape
    assert fused_block_probe.DEFAULT_SHAPE == (28, 28, 96, 128) and fused_block_probe.BATCH == 200
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fused_block_probe.main(["4", "5", "16", "8"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_on_the_card(dtype):
    """The kernel against its plain version (TF32 off) at the small cases,
    a ragged one (odd H and W, C_in 24, C_out 40) and a BN-Inception shape,
    to the tolerances above; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    for case in CASES + [(1, 13, 17, 24, 40), (4, 28, 28, 64, 96)]:
        x, weight, bias = (t.cuda() for t in _port(*_inputs(*case, seed=9), dtype))
        before = kernels.conv3x3.launches
        got = kernels.conv3x3(x, weight, bias)
        assert kernels.conv3x3.launches == before + 1
        want = kernels.conv3x3_plain(x, weight, bias)
        assert got.shape == want.shape and got.is_contiguous()
        if dtype == torch.float32:
            _assert_fp32_close(got.cpu().numpy(), want.cpu().numpy())
        else:
            assert_bf16_match(got.float().cpu().numpy(), want.float().cpu().numpy())


# ----------------------------------------------------------------- routes

# (x shape, C_out, route) at bf16: the probe's default and BN-Inception's
# inception_3a_double_3x3_1 keep the N tile's weight in shared memory; the
# weight of inception_5a_3x3 (C_in 192) does not fit beside the halos.
ROUTE_CASES = {
    "probe": ((200, 28, 28, 96), 128, "resident"),
    "inception_3a_double_3x3_1": ((250, 28, 28, 64), 96, "resident"),
    "inception_5a_3x3": ((250, 7, 7, 192), 320, "streaming"),
    "ragged": ((1, 13, 17, 24), 40, "resident"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_by_shape(case):
    shape, c_out, route = ROUTE_CASES[case]
    assert kernels.conv3x3_route(shape, c_out) == route
    assert kernels.conv3x3_route(shape, c_out, torch.float32) == "fma"


def test_resident_route_is_the_largest_that_fits_a_block():
    """The resident route takes C_in up to 96 (conv3x3.cu resident::kMaxCin:
    the largest whose block fits the H100's 227 KB of shared memory); from
    104 the weight streams."""
    assert kernels.CONV3X3_RESIDENT_MAX_C_IN == 96
    assert kernels.conv3x3_route((1, 4, 4, 96), 8) == "resident"
    assert kernels.conv3x3_route((1, 4, 4, 104), 8) == "streaming"
    assert kernels.CONV3X3_ROUTES == ("fma", "streaming", "resident")


@pytest.mark.parametrize("c_in, c_out", [(12, 8), (8, 12), (0, 8)])
def test_route_refuses_shapes_no_route_takes(c_in, c_out):
    with pytest.raises(ValueError, match="no route"):
        kernels.conv3x3_route((1, 4, 4, c_in), c_out)


# (B, H, W, C_in, C_out) on the card: a 7 x 7 image smaller than a tile; W
# = 17, not a multiple of the tile's 32 columns; several images in one
# batch; C_in 192, the streaming route.
CARD_CASES = {
    "image_smaller_than_a_tile": (3, 7, 7, 32, 64),
    "w_17": (2, 9, 17, 16, 24),
    "several_images": (6, 12, 12, 64, 96),
    "streaming_c_in_192": (4, 7, 7, 192, 320),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_routes_match_plain_on_the_card(case):
    """Each bf16 route against the plain version at KERNEL_TOL (|err| <=
    1e-2 + 1e-2 x max |plain|, chip_smoke.py's bound: one bf16 rounding
    apart), on the route conv3x3_route names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    b, h, w, c_in, c_out = CARD_CASES[case]
    x, weight, bias = (t.cuda() for t in _port(*_inputs(b, h, w, c_in, c_out, seed=11), BF16))
    assert kernels.conv3x3_library_route(x.shape, c_out) == kernels.conv3x3_route(x.shape, c_out)
    got = kernels.conv3x3(x, weight, bias).float()
    want = kernels.conv3x3_plain(x, weight, bias).float()
    assert (got - want).abs().max().item() <= 1e-2 + 1e-2 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("c_in", [32, 192], ids=["resident", "streaming"])
def test_cuda_nan_in_x_reaches_the_output(c_in):
    """A NaN in x reaches every output whose window holds it, as the plain
    version's (ReLU propagates NaN), and no other."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    x, weight, bias = (t.cuda() for t in _port(*_inputs(2, 9, 9, c_in, 16, seed=12), BF16))
    x[1, 4, 4, 3] = float("nan")
    got = kernels.conv3x3(x, weight, bias).float()
    want = kernels.conv3x3_plain(x, weight, bias).float()
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().sum() == 9 * 16
    finite = ~want.isnan()
    assert (got[finite] - want[finite]).abs().max().item() <= (
        1e-2 + 1e-2 * want[finite].abs().max().item())
