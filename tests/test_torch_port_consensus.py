"""Segment consensus fused with the classifier heads (tpu.fast_consensus
with the kernels on): the port's plain version against the JAX package's
reference and its Pallas kernel (interpret mode); the whole model with
fast consensus and ``tpu.use_pallas`` against the JAX model, with and
without 10-crop; the routing (eval with kernels only); and, on a card only,
the CUDA kernel against its plain version.

Tolerance: the consensus alone rtol 1e-5 (a 512-long fp32 dot product in
another order, atol 1e-6 for logits near 0); whole models as
tests/test_torch_port_model.py (logits rtol 1e-4 / atol 5e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from attention_based_tbn_tpu.ops.pallas_kernels import (
    consensus_heads_pallas,
    consensus_heads_reference,
)
from attention_based_tbn_tpu_torch.ops import kernels
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    assert_outputs_match,
    configs,
    jax_forward,
    make_batch,
    port_forward,
    port_model,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def _case(b=3, n=5, f=64, classes=(11, 13, 7), seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, n, f)).astype(np.float32)
    weights = [(rng.standard_normal((c, f)) * 0.1).astype(np.float32) for c in classes]
    biases = [(rng.standard_normal(c) * 0.1).astype(np.float32) for c in classes]
    return feats, weights, biases


@pytest.mark.parametrize("n", [2, 20])
def test_plain_matches_jax_reference_and_pallas(n):
    feats, weights, biases = _case(n=n, seed=n)
    jax_args = (jnp.asarray(feats), [jnp.asarray(w.T) for w in weights],
                [jnp.asarray(v) for v in biases])
    want = consensus_heads_reference(*jax_args)
    pallas = consensus_heads_pallas(*jax_args, interpret=True)
    got = kernels.consensus_heads_plain(torch.from_numpy(feats),
                                        [torch.from_numpy(w) for w in weights],
                                        [torch.from_numpy(v) for v in biases])
    assert len(got) == len(want) == 3
    for g, w, p in zip(got, want, pallas):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), **TOL)


def test_plain_reads_bf16_features_in_fp32():
    """At bf16 the mean over N is the fp32 mean of the widened features,
    rounded once; the heads are then TorchLinear in bf16, as the port's
    ``layers.linear`` computes them: the product rounded, then the sum with
    the rounded bias."""
    feats, weights, biases = _case(seed=3)
    bf = torch.from_numpy(feats).bfloat16()
    w = [torch.from_numpy(a).bfloat16() for a in weights]
    v = [torch.from_numpy(a).bfloat16() for a in biases]
    got = kernels.consensus_heads_plain(bf, w, v)
    pooled = bf.float().mean(dim=1).bfloat16()
    for g, wh, vh in zip(got, w, v):
        assert g.dtype == torch.float32
        want = (torch.nn.functional.linear(pooled, wh) + vh).float()
        torch.testing.assert_close(g, want, rtol=0, atol=0)


@pytest.mark.parametrize("crops", [1, 10], ids=["center", "ten_crop"])
def test_model_with_fast_consensus_kernel_matches_jax(crops, monkeypatch):
    cfg, jcfg = configs(["data.flow.enable=false", "tpu.fast_consensus=true",
                         "tpu.use_pallas=true"])
    model = port_model(cfg)
    calls = []
    plain = kernels.consensus_heads_plain
    monkeypatch.setattr(kernels, "consensus_heads_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    batch = make_batch(cfg, b=2 if crops == 1 else 1, seed=6, crops=crops)
    got = port_forward(model, batch)
    n = int(cfg.test.num_segments) * crops
    assert calls == [(2 if crops == 1 else 1, n, 512)]  # one call, every head
    assert_outputs_match(got, jax_forward(jcfg, model.state_dict(), batch))


def test_kernel_path_is_eval_with_kernels_only(monkeypatch):
    """use_pallas=false keeps the composition; the training forward keeps
    it too (the kernel has no backward)."""
    calls = []
    monkeypatch.setattr(kernels, "consensus_heads_plain", lambda *a: calls.append(1))
    cfg, _ = configs(["data.flow.enable=false", "tpu.fast_consensus=true",
                      "tpu.use_pallas=false"])
    model = port_model(cfg)
    out = port_forward(model, make_batch(cfg, seed=7))
    assert out["verb"].shape == (2, 125) and not calls
    cfg, _ = configs(["data.flow.enable=false", "tpu.fast_consensus=true",
                      "model.attention.attn_dropout=0", "model.fusion_dropout=0"])
    model = port_model(cfg).train()
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, seed=7).items()}
    out = model(batch, generator=torch.Generator().manual_seed(0))
    out["verb"].sum().backward()
    assert not calls and model.classifier["verb"].weight.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    feats, weights, biases = _case(b=10, n=250, f=512, classes=(125, 352))
    x = torch.from_numpy(feats).cuda().to(dtype)
    w = [torch.from_numpy(a).cuda().to(dtype) for a in weights]  # parameters in x's type
    v = [torch.from_numpy(a).cuda().to(dtype) for a in biases]
    before = kernels.consensus_heads.launches
    got = kernels.consensus_heads(x, w, v)
    assert kernels.consensus_heads.launches == before + 1
    # bf16: the two sum in another order, so a logit may round one ulp apart
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for g, want in zip(got, kernels.consensus_heads_plain(x, w, v)):
        torch.testing.assert_close(g, want, rtol=rtol, atol=1e-5)


# ---------------------------------------------------------- kernel operands


def _heads(classes=(11, 13), f=64, dtype=torch.bfloat16, seed=1):
    _, weights, biases = _case(f=f, classes=classes, seed=seed)
    return ([torch.from_numpy(w).to(dtype) for w in weights],
            [torch.from_numpy(v).to(dtype) for v in biases])


def test_operands_are_made_once_per_version():
    """The ctypes pointer and class-count arrays are built once per version
    of the heads' tensors (as conv3x3_operands): a repeated call returns the
    same object, an in-place update of a weight makes new ones."""
    weights, biases = _heads(classes=(11, 13, 7))
    ops = kernels.consensus_heads_operands(weights, biases)
    assert ops.count == 3 and ops.total == 31 and ops.features == 64
    assert list(ops.class_counts) == [11, 13, 7] and ops.heads == [(11, 0), (13, 11), (7, 24)]
    assert list(ops.weight_ptrs) == [w.data_ptr() for w in weights]
    assert list(ops.bias_ptrs) == [v.data_ptr() for v in biases]
    assert ops.device_index == -1  # heads off the card: no CUDA tensor's get_device()
    assert kernels.consensus_heads_operands(tuple(weights), tuple(biases)) is ops
    weights[1].add_(0)
    again = kernels.consensus_heads_operands(weights, biases)
    assert again is not ops and list(again.weight_ptrs) == list(ops.weight_ptrs)
    assert kernels.consensus_heads_operands(weights, biases) is again
    other = [w.clone() for w in weights]
    assert kernels.consensus_heads_operands(other, biases) is not again


PARAM_ERRORS = {
    "five_heads": (lambda w, b: (w * 5, b * 5), "1 to 4 heads"),
    "bias_count": (lambda w, b: (w, b[:1]), "1 to 4 heads"),
    "feature_width": (lambda w, b: ([w[0], w[1][:, :32].contiguous()], b), "do not fit"),
    "bias_shape": (lambda w, b: (w, [b[0], b[1][:5]]), "do not fit"),
    "mixed_types": (lambda w, b: ([w[0], w[1].float()], b), "contiguous"),
    "not_contiguous": (lambda w, b: ([w[0], w[1].T.contiguous().T], b), "contiguous"),
    "too_wide": (lambda w, b: ([torch.zeros(3, 4097, dtype=torch.bfloat16)],
                               [torch.zeros(3, dtype=torch.bfloat16)]), "F <= 4096"),
    "int_type": (lambda w, b: ([x.int() for x in w], [x.int() for x in b]), "dtype"),
}


@pytest.mark.parametrize("case", sorted(PARAM_ERRORS))
def test_operands_refuse_what_the_kernel_cannot_take(case):
    make, message = PARAM_ERRORS[case]
    weights, biases = make(*_heads())
    assert message in kernels.consensus_heads_params_error(weights, biases)
    with pytest.raises(ValueError, match=message):
        kernels.consensus_heads_operands(weights, biases)


# (B, N, F, heads, offset) on the card: one segment row (fewer rows than
# the cluster's 8 blocks); 25 rows split over the cluster; F = 1024 (a
# single-modality model without Fusion); one clip; one, three and four
# heads; and the element-wise loads: F = 100 (not a multiple of 8 or 4), and
# features `offset` elements into their buffer (not on 16 bytes).
CARD_CASES = {
    "n_1": (2, 1, 512, (125, 352), 0),
    "n_25": (10, 25, 512, (125, 352), 0),
    "f_1024": (2, 25, 1024, (125, 352), 0),
    "b_1": (1, 250, 512, (125, 352), 0),
    "one_head": (2, 25, 512, (97,), 0),
    "three_heads": (2, 25, 512, (125, 352, 97), 0),
    "four_heads": (3, 10, 512, (125, 352, 97, 8), 0),
    "f_100": (2, 25, 100, (125, 352), 0),
    "offset_features": (2, 25, 512, (125, 352), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_kernel_matches_plain_at_every_shape(case, dtype):
    """The cluster kernel against its plain version at KERNEL_TOL (|err| <=
    atol + rtol x max |plain|: 1e-4 at fp32, a summation order apart; 1e-2 at
    bf16, a logit one bf16 rounding apart), each head a contiguous (B, C_h)
    float32 tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    b, n, f, classes, offset = CARD_CASES[case]
    feats, weights, biases = _case(b=b, n=n, f=f, classes=classes, seed=b + n)
    x = torch.empty(offset + feats.size, device="cuda", dtype=dtype)[offset:].view(b, n, f)
    x.copy_(torch.from_numpy(feats))
    w = [torch.from_numpy(a).cuda().to(dtype) for a in weights]
    v = [torch.from_numpy(a).cuda().to(dtype) for a in biases]
    got = kernels.consensus_heads(x, w, v)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for g, want, c in zip(got, kernels.consensus_heads_plain(x, w, v), classes):
        assert g.shape == (b, c) and g.dtype == torch.float32 and g.is_contiguous()
        assert (g - want).abs().max().item() <= tol + tol * want.abs().max().item()


@pytest.mark.cuda
def test_cuda_kernel_refuses_heads_off_the_card():
    """Heads left on the CPU with features on the card raise before a
    launch: host pointers never reach the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    feats, weights, biases = _case(b=2, n=25, f=512, classes=(125, 352))
    before = kernels.consensus_heads.launches
    with pytest.raises(ValueError, match="one card"):
        kernels.consensus_heads(torch.from_numpy(feats).cuda(),
                                [torch.from_numpy(w) for w in weights],
                                [torch.from_numpy(v) for v in biases])
    assert kernels.consensus_heads.launches == before
