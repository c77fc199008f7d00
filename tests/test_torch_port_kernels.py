"""The port's attention-block kernels: plain versions against the JAX
package's references and its Pallas kernels (interpret mode), the CPU
dispatch rule of the wrappers, and — on a card only — each CUDA kernel
against its plain version.

Tolerance: fp32 rtol 1e-4 / atol 1e-4 — the two sides differ only in
summation order (the JAX package's own Pallas tests use the same bound).
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from attention_based_tbn_tpu.models.attention import (
    positional_encoding_table as jax_positional_encoding_table,
)
from attention_based_tbn_tpu.ops.pallas_kernels import (
    mha_pallas,
    mha_reference,
    pe_block_pallas,
    pe_block_reference,
)
from attention_based_tbn_tpu_torch.models.attention import positional_encoding_table
from attention_based_tbn_tpu_torch.ops import build, kernels
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
D = 10  # PE channels


def _pe_case(b, s, c, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, s, c)).astype(np.float32),
        table=positional_encoding_table(D, s),
        kernel=(rng.standard_normal((c + D, c)) * 0.05).astype(np.float32),  # (in, out)
        bias=(rng.standard_normal(c) * 0.1).astype(np.float32),
        scale=(rng.random(c) + 0.5).astype(np.float32),
        gn_bias=(rng.standard_normal(c) * 0.1).astype(np.float32),
    )


def _mha_case(b, s, e, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: (rng.standard_normal(shape) * 0.05).astype(np.float32)  # noqa: E731
    return dict(
        query=rng.standard_normal((b, e)).astype(np.float32),
        keyval=rng.standard_normal((b, s, e)).astype(np.float32),
        wq=mk(e, e), bq=mk(e), wk=mk(e, e), bk=mk(e), wv=mk(e, e), bv=mk(e),
        wo=mk(e, e), bo=mk(e),
    )


def _port_pe_args(c):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    return (t["x"], t["table"], t["kernel"].T.contiguous(), t["bias"], t["scale"], t["gn_bias"])


def _port_mha_args(c):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    in_w = torch.cat([t["wq"].T, t["wk"].T, t["wv"].T]).contiguous()
    in_b = torch.cat([t["bq"], t["bk"], t["bv"]])
    return t["query"], t["keyval"], in_w, in_b, t["wo"].T.contiguous(), t["bo"]


def test_positional_encoding_table_matches_jax():
    for dim, length in ((10, 13), (10, 8), (6, 25)):
        np.testing.assert_array_equal(
            positional_encoding_table(dim, length), jax_positional_encoding_table(dim, length)
        )


@pytest.mark.parametrize("b,s,c,groups", [(3, 13, 256, 64), (5, 8, 128, 32), (1, 13, 192, 64)])
def test_pe_block_plain_matches_jax(b, s, c, groups):
    case = _pe_case(b, s, c, seed=b + s)
    j = {k: jnp.asarray(v) for k, v in case.items()}
    args = (j["x"], j["table"], j["kernel"], j["bias"], j["scale"], j["gn_bias"])
    ref = np.asarray(pe_block_reference(*args, num_groups=groups))
    pallas = np.asarray(pe_block_pallas(*args, num_groups=groups, interpret=True))
    ours = kernels.pe_block_plain(*_port_pe_args(case), num_groups=groups).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, pallas, **TOL)


@pytest.mark.parametrize("b,s,e,heads", [(3, 13, 128, 4), (5, 8, 256, 4), (7, 13, 256, 8)])
def test_mha_plain_matches_jax(b, s, e, heads):
    case = _mha_case(b, s, e, seed=b * s)
    j = {k: jnp.asarray(v) for k, v in case.items()}
    ref_out, ref_wts = mha_reference(num_heads=heads, **j)
    pal_out, pal_wts = mha_pallas(num_heads=heads, interpret=True, **j)
    out, wts = kernels.mha_plain(*_port_mha_args(case), num_heads=heads)
    for want_out, want_wts in ((ref_out, ref_wts), (pal_out, pal_wts)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
        np.testing.assert_allclose(wts.numpy(), np.asarray(want_wts), rtol=1e-4, atol=1e-5)


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU a wrapper is exactly its plain version and counts no
    launch; it does so because the tensors lie on the CPU."""
    kernels.reset_launch_counts()
    pe = _port_pe_args(_pe_case(3, 13, 128, seed=1))
    torch.testing.assert_close(kernels.pe_block(*pe, num_groups=64),
                               kernels.pe_block_plain(*pe, num_groups=64), rtol=0, atol=0)
    mha = _port_mha_args(_mha_case(3, 13, 128, seed=2))
    for got, want in zip(kernels.mha(*mha, num_heads=4), kernels.mha_plain(*mha, num_heads=4)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernels.pe_block.launches == 0 and kernels.mha.launches == 0


def test_plain_versions_keep_the_input_dtype():
    pe = list(_port_pe_args(_pe_case(2, 8, 128, seed=3)))
    pe[0] = pe[0].to(torch.bfloat16)
    assert kernels.pe_block_plain(*pe, num_groups=32).dtype == torch.bfloat16
    mha = list(_port_mha_args(_mha_case(2, 8, 128, seed=4)))
    mha[0], mha[1] = mha[0].to(torch.bfloat16), mha[1].to(torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in kernels.mha_plain(*mha, num_heads=4))


def test_wrappers_refuse_other_devices():
    """Neither CPU nor CUDA: no kernel and no silent plain fallback."""
    pe = _port_pe_args(_pe_case(2, 8, 128, seed=5))
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.pe_block(pe[0].to("meta"), *pe[1:], num_groups=32)
    mha = _port_mha_args(_mha_case(2, 8, 128, seed=6))
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.mha(mha[0].to("meta"), mha[1].to("meta"), *mha[2:], num_heads=4)


def test_library_path_follows_every_header(tmp_path):
    """Editing or adding a shared header under csrc/ changes every
    library's path, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    for name in build.KERNELS:
        assert build.library_path(name, str(csrc)) == build.library_path(name)
    header = csrc / "wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {name: build.library_path(name, str(csrc)) for name in build.KERNELS}
    assert all(edited[n] != build.library_path(n) for n in build.KERNELS)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(build.library_path(n, str(csrc)) != edited[n] for n in build.KERNELS)


def test_wrappers_name_the_parameter_dtype_they_take():
    """At bf16 the attention kernels take bf16 parameters (the model's
    rounded ones) and refuse float32 ones, naming the dtype they take."""
    q, kv, *params = _port_mha_args(_mha_case(2, 8, 128, seed=9))
    with pytest.raises(ValueError, match="must be torch.bfloat16"):
        kernels._check_param("mha", "in_proj_weight", params[0], q.device, torch.bfloat16)
    kernels._check_param("mha", "in_proj_weight", params[0].bfloat16(), q.device, torch.bfloat16)


def _bf16_pe(b=2, s=13, c=128):
    """A valid bf16 call: (x, split, scale, shift)."""
    args = [t.bfloat16() for t in _port_pe_args(_pe_case(b, s, c, seed=12))]
    return args[0], kernels.pe_block_split(*args[1:4]), args[4], args[5]


def _fp32_pe(s):
    return list(_port_pe_args(_pe_case(2, s, 128, seed=12)))


# (case, message, call): what the wrappers refuse; each call edits a valid
# bf16 call (x, split, scale, shift) of pe_block_bf16, or makes one of the
# float32 pe_block, and returns (wrapper, arguments, groups).
_PE_REFUSED = {
    "seq_over_64_bf16": ("sequence 65 outside [1, 64]",
                         lambda x, sp, *n: ("bf16", (x.new_zeros(2, 65, 128), sp, *n), 32)),
    "seq_over_16_fp32": ("sequence 17 outside [1, 16]",
                         lambda *a: ("fp32", tuple(_fp32_pe(17)), 32)),
    "c_in_not_64": ("C_in 96 must be a multiple of 64",
                    lambda x, sp, *n: ("bf16", (x[..., :96].contiguous(),
                                                (sp[0][:, :96].contiguous(), sp[1]), *n), 32)),
    "c_out_not_64": ("multiple of 64",
                     lambda x, sp, *n: ("bf16", (x, (sp[0][:96], sp[1][:, :96]),
                                                 *[t[:96] for t in n]), 32)),
    "group_of_2": ("channels per group", lambda *a: ("bf16", a, 64)),
    "no_split": ("call pe_block_bf16",
                 lambda *a: ("fp32", tuple([a[0]] + [t.bfloat16() for t in _fp32_pe(13)[1:]]),
                             32)),
    "float32_to_wgmma": ("takes bf16 activations",
                         lambda x, *r: ("bf16", (x.float(), *r), 32)),
    "split_float32": ("split weight",
                      lambda x, sp, *n: ("bf16", (x, (sp[0].float(), sp[1]), *n), 32)),
    "split_bias_bf16": ("split PE bias",
                        lambda x, sp, *n: ("bf16", (x, (sp[0], sp[1].bfloat16()), *n), 32)),
    "misaligned_x": ("16 bytes",
                     lambda x, *r: ("bf16", (torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:]
                                             .view(x.shape), *r), 32)),
    "noncontiguous_x": ("contiguous",
                        lambda x, *r: ("bf16", (torch.cat([x, x], -1)[..., :128], *r), 32)),
}


@pytest.mark.parametrize("case", sorted(_PE_REFUSED))
def test_pe_block_limits_refused_without_a_card(case):
    """The kernels' limits (S <= 64 at bf16 and 16 at fp32, C_in and C_out
    multiples of 64 at bf16, 4-64 channels per group, each wrapper its own
    dtype, the split operands' type, shape and 16-byte alignment) are
    refused before any library loads."""
    checks = {"bf16": (kernels.pe_block_bf16_shape_error, kernels.pe_block_bf16),
              "fp32": (kernels.pe_block_shape_error, kernels.pe_block)}
    valid = _bf16_pe()
    assert kernels.pe_block_bf16_shape_error(*valid, num_groups=32) == ""
    assert kernels.pe_block_shape_error(*_fp32_pe(13), num_groups=32) == ""
    message, call = _PE_REFUSED[case]
    route, args, groups = call(*valid)
    shape_error, wrapper = checks[route]
    assert message in shape_error(*args, num_groups=groups)
    with pytest.raises(ValueError, match="no kernel for device"):  # never the plain twin
        wrapper(args[0].to("meta"), *args[1:], num_groups=groups)


def test_pe_block_split_is_the_same_function():
    """x @ w_x^T + pe_bias == [x | PE] @ W^T + b in float32 (the split the
    bf16 kernel takes), and the split twin agrees with the concat one."""
    args = _port_pe_args(_pe_case(3, 13, 128, seed=13))
    w_x, pe_bias = kernels.pe_block_split(*args[1:4])
    torch.testing.assert_close(w_x, args[2][:, :128], rtol=0, atol=0)
    x, table, weight, bias = args[:4]
    concat = torch.cat([x, table[None].expand(3, -1, -1)], dim=-1) @ weight.T + bias
    torch.testing.assert_close(x @ w_x.T + pe_bias, concat, **TOL)
    torch.testing.assert_close(kernels.pe_block_split_plain(x, (w_x, pe_bias), *args[4:]),
                               kernels.pe_block_plain(*args), **TOL)


def test_pe_block_bf16_on_the_cpu_is_its_plain_version():
    """On CPU tensors the bf16 wrapper is exactly the split twin (the wgmma
    kernel's arithmetic) and counts no launch."""
    kernels.reset_launch_counts()
    x, split, scale, shift = _bf16_pe()
    got = kernels.pe_block_bf16(x, split, scale, shift, num_groups=32)
    want = kernels.pe_block_split_plain(x, split, scale, shift, num_groups=32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.dtype == torch.bfloat16 and kernels.pe_block.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pe_block_limits_match_the_library(dtype):
    """The limits the wrappers check without a card are the built
    library's own (pe_block.cu's pe_block_limits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device to build and load the library")
    assert kernels.pe_block_library_limits(dtype) == kernels.PE_BLOCK_LIMITS[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [25, 250, 500])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_cuda_kernels_match_plain_on_the_card(dtype, atol, rows):
    """Flagship shapes (B*N 25, 250 and the evaluation batch's 500, S 13, E
    1024), parameters in the activations' type (the bf16 pe_block and mha
    run on wgmma; pe_block_bf16 takes the split operands). |err| <= atol +
    rtol*max|plain| with rtol = atol: fp32 summation order, plus bf16
    output rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    pe = [t.cuda().to(dtype) for t in _port_pe_args(_pe_case(rows, 13, 1024, seed=7))]
    pe[1] = pe[1].T.contiguous().T  # the table as the model passes it: a strided view
    if dtype == torch.bfloat16:
        got = kernels.pe_block_bf16(pe[0], kernels.pe_block_split(*pe[1:4]), *pe[4:])
    else:
        got = kernels.pe_block(*pe)
    mha = [t.cuda().to(dtype) for t in _port_mha_args(_mha_case(rows, 13, 1024, seed=8))]
    torch.backends.cuda.matmul.allow_tf32 = False
    pairs = [(got, kernels.pe_block_plain(*pe))]
    pairs += list(zip(kernels.mha(*mha, num_heads=4), kernels.mha_plain(*mha, num_heads=4)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.dtype == want.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol * (1 + want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("swizzle", [False, True], ids=["interleave", "swizzle128"])
def test_wgmma_descriptor_on_the_card(swizzle):
    """One warpgroup's m64n64k16 (K = 16, no swizzle) and a K = 64 product
    in the kernels' 128-byte-swizzled layout against torch.matmul: exact
    bf16 products, fp32 sums in another order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; wgmma has no CPU mode")
    k = 64 if swizzle else 16
    gen = torch.Generator().manual_seed(k)
    a, b = (torch.randn(64, k, generator=gen).bfloat16().cuda() for _ in range(2))
    got = kernels.wgmma_probe(a, b, swizzle)
    torch.testing.assert_close(got, a.float() @ b.float().T, rtol=1e-5, atol=1e-5)
