"""The port's general MultiheadAttention (models/attention.py): query
(B, L, E), key and value (B, S, E), against the JAX package's module on the
same weights, and its dispatch: the kernel route only where the JAX package
takes ``mha_pallas`` (L == 1, key is value, eval, kernels on), the TBN's
wrapper ``MHAttention`` unchanged."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.models.attention import MultiheadAttention as JaxMHA
from attention_based_tbn_tpu_torch.models.attention import (
    MHAttention, MultiheadAttention, multi_head_attention,
)
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.ops import kernels

from torch_port_helpers import one_torch_thread  # noqa: F401

E, HEADS, B, S = 64, 4, 3, 7


def _mha(seed=0, dropout_rate=0.0):
    mha = MultiheadAttention(E, HEADS, dropout_rate)
    mha.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # biases off zero, so a bias slip shows
        gen = torch.Generator().manual_seed(seed + 1)
        mha.in_proj_bias.copy_(torch.randn(3 * E, generator=gen) * 0.1)
        mha.out_proj.bias.copy_(torch.randn(E, generator=gen) * 0.1)
    return mha.eval()


def _jax_params(mha):
    sd = {f"attention_layer.attention_layer.{k}": v for k, v in mha.state_dict().items()}
    return jax.tree.map(jnp.asarray, state_dict_to_jax(sd)["params"]["attention_layer"])


def _inputs(length, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, length, E)).astype(dtype)
    k = rng.standard_normal((B, S, E)).astype(dtype)
    v = rng.standard_normal((B, S, E)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("length", [1, 3])
def test_general_mha_matches_jax_fp32(length):
    """fp32, key != value: output and head-averaged weights within 1e-5 of
    the JAX module's (its plain composition, the only one it has there)."""
    mha = _mha(seed=length)
    q, k, v = _inputs(length, seed=10 + length)
    with torch.no_grad():
        out, wts = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       use_kernels=True)
    assert out.shape == (B, length, E) and wts.shape == (B, length, S)
    want_out, want_wts = JaxMHA(embed_dim=E, num_heads=HEADS, dropout_rate=0.0).apply(
        {"params": _jax_params(mha)}, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        train=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wts.numpy(), np.asarray(want_wts), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wts.sum(-1).numpy(), 1.0, atol=1e-5)


def test_general_mha_matches_jax_bf16():
    """bf16, L = 3: the same roundings as the JAX composition (projections
    in bf16, q scaled before the product, softmax in fp32, probabilities
    rounded to bf16, fp32 accumulation); the two differ only in summation
    order, so within two bf16 ulps of max |out| and of 1 for the weights."""
    mha = _mha(seed=5)
    q, k, v = _inputs(3, seed=21)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    with torch.no_grad():
        out, wts = mha(tq, tk, tv, use_kernels=False)
    assert out.dtype == wts.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (tq, tk, tv))
    want_out, want_wts = JaxMHA(embed_dim=E, num_heads=HEADS, dropout_rate=0.0,
                                dtype=jnp.bfloat16).apply(
        {"params": _jax_params(mha)}, jq, jk, jv, train=False)
    want_out = np.asarray(want_out, np.float32)
    assert np.abs(out.float().numpy() - want_out).max() <= 2.0 ** -7 * np.abs(want_out).max()
    assert np.abs(wts.float().numpy() - np.asarray(want_wts, np.float32)).max() <= 2.0 ** -7


def _spy(monkeypatch):
    calls = []
    for name in ("mha", "mha_plain"):
        real = getattr(kernels, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(kernels, name, spy)
    return calls


@pytest.mark.parametrize("case,route", [
    ("single_kv_eval_kernels", ["mha"]),
    ("single_kv_eval_plain", ["mha_plain"]),
    ("single_kv_train", ["mha_plain"]),
    ("single_key_not_value", []),
    ("three_queries", []),
])
def test_kernel_route_only_where_jax_takes_the_pallas_kernel(monkeypatch, case, route):
    """JAX's dispatch (attention.py:163-174): the kernel for L == 1, key is
    value, eval, kernels on; the single-query plain version where the kernel
    would apply but is off or training; the general composition otherwise."""
    mha = _mha(seed=7)
    q, k, v = (torch.from_numpy(a) for a in _inputs(3 if case == "three_queries" else 1, 30))
    value = k if case.startswith("single_kv") else v
    use_kernels = case != "single_kv_eval_plain"
    if case == "single_kv_train":
        mha.train()
    calls = _spy(monkeypatch)
    out, wts = mha(q, k, value, use_kernels, torch.Generator())
    assert calls[:1] == route  # on the CPU kernels.mha runs mha_plain inside
    assert out.shape == q.shape and wts.shape == (B, q.shape[1], S)


def test_key_not_value_equals_the_single_query_route_on_equal_inputs():
    """L == 1 with key and value equal in content but not the same tensor
    runs the general composition, which agrees with the kernel's plain
    arithmetic at fp32 (1e-5)."""
    mha = _mha(seed=8)
    q, k, _ = (torch.from_numpy(a) for a in _inputs(1, 31))
    with torch.no_grad():
        general = mha(q, k, k.clone(), use_kernels=False)
        single = mha(q, k, k, use_kernels=False)
    for a, b in zip(general, single):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tbn_wrapper_is_bit_equal_to_the_single_query_kernel_call(dtype):
    """MHAttention (the TBN's call site) gives exactly what the single-query
    kernel function gives on the same rounded parameters: (B, E) out and
    (B, 1, S) weights."""
    wrapper = MHAttention(E, HEADS)
    wrapper.attention_layer.load_state_dict(_mha(seed=9).state_dict())
    wrapper.eval()
    rng = np.random.default_rng(32)
    q = torch.from_numpy(rng.standard_normal((B, E)).astype(np.float32)).to(dtype)
    kv = torch.from_numpy(rng.standard_normal((B, S, E)).astype(np.float32)).to(dtype)
    layer = wrapper.attention_layer
    params = [t.detach().to(dtype) for t in (layer.in_proj_weight, layer.in_proj_bias,
                                             layer.out_proj.weight, layer.out_proj.bias)]
    for use_kernels, fn in ((True, kernels.mha), (False, kernels.mha_plain)):
        with torch.no_grad():
            out, wts = wrapper(q, kv, use_kernels)
        want_out, want_wts = fn(q, kv, *params, HEADS)
        assert out.shape == (B, E) and wts.shape == (B, 1, S)
        assert torch.equal(out, want_out) and torch.equal(wts[:, 0], want_wts)


def test_general_mha_training_drops_the_weights_and_reaches_the_parameters():
    """Training: the weights returned are the head mean of the dropped
    probabilities (rows no longer sum to 1), and the gradients reach every
    projection."""
    mha = _mha(seed=11, dropout_rate=0.5).train()
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 33))
    out, wts = mha(q, k, v, True, torch.Generator().manual_seed(0))
    assert not torch.allclose(wts.sum(-1), torch.ones(B, 3))
    (out.sum() + wts.sum()).backward()
    assert mha.in_proj_weight.grad.abs().sum() > 0 and mha.out_proj.weight.grad.abs().sum() > 0
    with torch.no_grad():  # without dropout the same call's rows sum to 1
        _, clean_wts = multi_head_attention(
            q, k, v, mha.in_proj_weight, mha.in_proj_bias, mha.out_proj.weight,
            mha.out_proj.bias, HEADS)
    torch.testing.assert_close(clean_wts.sum(-1), torch.ones(B, 3))
