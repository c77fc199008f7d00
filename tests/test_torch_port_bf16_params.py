"""bf16 parameter rounding: the port rounds the attention block's and the
consensus heads' parameters to the compute dtype as the JAX package's call
sites do (attention.py:115-119 and :181-186, TorchLinear at
layers.py:624-625, fast_consensus at tbn.py:430-440), on every path.

At bf16 the port's modules (plain versions on the CPU) are held against
the JAX package's Pallas kernels in interpret mode, fed as the JAX modules
feed them. The criterion: at least 99% of the outputs bit-equal, and the
largest gap at most one bf16 ulp of max |out| (the two sides sum the same
exact products in another order, so a rounding boundary is crossed now and
then, by one ulp). With float32 parameters the port matched 43-50% of the
module outputs and none of the consensus logits.

Also: the training-mode MHA against the JAX composition in bf16, the cast
cache (refreshed by ``load_state_dict`` and by an optimizer step, no cast
on a cached forward, float32 untouched), and the kernels-on and
kernels-off branches of the model agreeing bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.models.attention import MultiheadAttention as JaxMHA
from attention_based_tbn_tpu.models.heads import Classifier as JaxClassifier
from attention_based_tbn_tpu.ops.pallas_kernels import mha_pallas, pe_block_pallas
from attention_based_tbn_tpu_torch.models.attention import (
    MHAttention,
    PositionalEncoding,
    positional_encoding_table,
)
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.models.heads import Classifier
from attention_based_tbn_tpu_torch.models.layers import CastCache
from attention_based_tbn_tpu_torch.ops import kernels
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    configs,
    make_batch,
    one_torch_thread,
    port_model,
)

BF16 = jnp.bfloat16
B, S, E, HEADS, D = 16, 13, 1024, 4, 10


def assert_bf16_match(got, want, min_equal=0.99):
    """``min_equal`` of the outputs bit-equal; the largest gap at most one
    bf16 ulp of max |want| (2 ** (floor(log2 max) - 7))."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    equal = float(np.mean(got == want))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    gap = float(np.abs(got - want).max())
    assert equal >= min_equal and gap <= ulp, f"bit-equal {equal:.4f}, gap {gap} > ulp {ulp}"


def _perturbed(module, seed):
    """Seeded init plus random biases and norm affines (not the identity)."""
    gen = torch.Generator().manual_seed(seed)
    module.reset_parameters(gen)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias") or (p.dim() == 1 and "weight" in name):
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return module.eval()


def _bf16_input(*shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16(), jnp.asarray(x).astype(BF16)


def test_pe_module_matches_pallas_in_bf16():
    pe = _perturbed(PositionalEncoding(max_len=S), seed=1)
    x, jx = _bf16_input(B, S, E, seed=2)
    with torch.no_grad():
        got = pe(x, use_kernels=True).float().numpy()
    conv, norm = pe[1], pe[2]
    jnp_of = lambda t: jnp.asarray(t.detach().numpy())  # noqa: E731
    want = pe_block_pallas(
        jx, jnp.asarray(positional_encoding_table(D, S)).astype(BF16),
        jnp_of(conv.weight[:, :, 0].T).astype(BF16), jnp_of(conv.bias).astype(BF16),
        jnp_of(norm.weight).astype(BF16), jnp_of(norm.bias).astype(BF16),
        num_groups=norm.num_groups, interpret=True)
    assert_bf16_match(got, want)


def _jax_mha_params(mha):
    state = {f"attention_layer.{k}": v for k, v in mha.state_dict().items()}
    return jax.tree.map(jnp.asarray, state_dict_to_jax(state)["params"]["attention_layer"])


def test_mha_module_matches_pallas_in_bf16():
    mha = _perturbed(MHAttention(E, HEADS), seed=3)
    q, jq = _bf16_input(B, E, seed=4)
    kv, jkv = _bf16_input(B, S, E, seed=5)
    with torch.no_grad():
        out, wts = mha(q, kv, use_kernels=True)
    p = _jax_mha_params(mha)
    cast = lambda t: t.astype(BF16)  # noqa: E731 (the JAX call site's cast)
    want_out, want_wts = mha_pallas(
        jq, jkv, *[cast(p[n][k]) for n in ("q_proj", "k_proj", "v_proj", "out_proj")
                   for k in ("kernel", "bias")], num_heads=HEADS, interpret=True)
    assert_bf16_match(out.float().numpy(), want_out)
    assert_bf16_match(wts[:, 0].float().numpy(), want_wts)


def _heads(f=512, classes=(125, 352), seed=6):
    head = Classifier(f, {"verb": classes[0], "noun": classes[1]})
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return head


def test_consensus_branch_matches_jax_fast_consensus_in_bf16():
    """The kernels-on branch's consensus_heads (plain on the CPU), fed the
    heads rounded as the model feeds them, against the JAX model's
    composition: fp32 mean rounded to bf16, Classifier(dtype=bf16)."""
    head = _heads()
    feats = np.maximum(np.random.default_rng(7).standard_normal((8, 50, 512)), 0)
    x = torch.from_numpy(feats.astype(np.float32)).bfloat16()
    with torch.no_grad():
        params = CastCache().get("heads", tuple(
            t for h in head.values() for t in (h.weight, h.bias)), torch.bfloat16)
        got = kernels.consensus_heads_plain(x, list(params[0::2]), list(params[1::2]))
    pooled = jnp.asarray(x.float().numpy()).mean(axis=1).astype(BF16)
    variables = {"params": {name: {"kernel": jnp.asarray(h.weight.detach().numpy().T),
                                   "bias": jnp.asarray(h.bias.detach().numpy())}
                            for name, h in head.items()}}
    want = JaxClassifier({"verb": 125, "noun": 352}, dtype=BF16).apply(variables, pooled)
    for g, name in zip(got, ("verb", "noun")):
        assert_bf16_match(g.numpy(), np.asarray(want[name].astype(jnp.float32)))


@pytest.mark.parametrize("crops", [1, 10], ids=["center", "ten_crop"])
def test_kernels_on_and_off_agree_bit_for_bit_in_bf16(crops):
    """fast_consensus at bf16 on the CPU: tpu.use_pallas on (consensus_heads
    and the attention kernels' plain versions) and off (the compositions)
    give the same logits and weights, bit for bit."""
    outs = []
    for use in ("true", "false"):
        cfg, _ = configs(["data.flow.enable=false", "tpu.fast_consensus=true",
                          "tpu.compute_dtype=bfloat16", f"tpu.use_pallas={use}"])
        model = port_model(cfg)
        batch = make_batch(cfg, b=2 if crops == 1 else 1, seed=8, crops=crops)
        with torch.no_grad():
            outs.append(model({k: torch.from_numpy(v) for k, v in batch.items()}))
    assert set(outs[0]) == set(outs[1]) == {"verb", "noun", "weights"}
    for key in outs[0]:
        torch.testing.assert_close(outs[0][key], outs[1][key], rtol=0, atol=0, msg=key)


def test_train_mha_matches_jax_composition_in_bf16():
    """Training (dropout 0): the port's MHA on its bf16-rounded parameters
    against the JAX module's TorchLinear composition in bf16.

    The JAX composition also rounds q, k and v, the probabilities and the
    attended values to bf16; the port keeps those in fp32 (the Pallas
    kernel's numerics) and rounds only its outputs. Five extra roundings of
    at most half a bf16 ulp each (2 ** -9 relative), carried through the
    products, bound the gap by a few ulps of max |out|: 4 ulps (2 ** -6
    relative) for the output, and for the weights, which sum to 1, 4 ulps
    of 1. The gradients reach the float32 parameters."""
    mha = _perturbed(MHAttention(E, HEADS, dropout_rate=0.0), seed=9).train()
    q, jq = _bf16_input(B, E, seed=10)
    kv, jkv = _bf16_input(B, S, E, seed=11)
    out, wts = mha(q, kv, use_kernels=True, generator=torch.Generator())
    (out.float().sum() + wts.float().sum()).backward()
    layer = mha.attention_layer
    assert layer.in_proj_weight.grad is not None and layer.in_proj_weight.dtype == torch.float32
    assert layer.out_proj.weight.grad.abs().sum() > 0

    want_out, want_wts = JaxMHA(embed_dim=E, num_heads=HEADS, dropout_rate=0.0, dtype=BF16).apply(
        {"params": _jax_mha_params(mha)}, jq[:, None], jkv, jkv, train=True)
    got_out = out.detach().float().numpy()
    want_out = np.asarray(want_out[:, 0], np.float32)
    assert out.dtype == wts.dtype == torch.bfloat16
    assert np.abs(got_out - want_out).max() <= 2.0 ** -6 * np.abs(want_out).max()
    got_wts = wts[:, 0].detach().float().numpy()
    assert np.abs(got_wts - np.asarray(want_wts[:, 0], np.float32)).max() <= 2.0 ** -6


# ------------------------------------------------------------- cast cache


def _mha_cache_hits(mha, q, kv):
    calls = []
    real = kernels.mha_plain

    def spy(*args, **kw):
        calls.append(args[2:6])
        return real(*args, **kw)

    kernels.mha_plain = spy
    try:
        with torch.no_grad():
            mha(q, kv, use_kernels=False)
    finally:
        kernels.mha_plain = real
    return calls[0]


def test_cast_cache_refreshes_after_load_state_dict():
    mha = _perturbed(MHAttention(64, 4), seed=12)
    q, kv = torch.randn(2, 64).bfloat16(), torch.randn(2, 3, 64).bfloat16()
    first = _mha_cache_hits(mha, q, kv)
    assert all(t.dtype == torch.bfloat16 for t in first)
    again = _mha_cache_hits(mha, q, kv)
    assert all(a is b for a, b in zip(first, again))  # cached: no cast launched
    other = _perturbed(MHAttention(64, 4), seed=13)
    mha.load_state_dict(other.state_dict())
    fresh = _mha_cache_hits(mha, q, kv)
    layer = mha.attention_layer
    torch.testing.assert_close(fresh[0], layer.in_proj_weight.detach().bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(fresh[3], layer.out_proj.bias.detach().bfloat16(), rtol=0, atol=0)
    assert not torch.equal(fresh[0], first[0])


def test_cast_cache_refreshes_after_an_optimizer_step():
    mha = _perturbed(MHAttention(64, 4), seed=14)
    q, kv = torch.randn(2, 64).bfloat16(), torch.randn(2, 3, 64).bfloat16()
    before = _mha_cache_hits(mha, q, kv)
    mha.train()
    out, _ = mha(q, kv, use_kernels=False, generator=torch.Generator())
    out.float().sum().backward()
    torch.optim.SGD(mha.parameters(), lr=0.5).step()
    mha.eval()
    after = _mha_cache_hits(mha, q, kv)
    layer = mha.attention_layer
    torch.testing.assert_close(after[0], layer.in_proj_weight.detach().bfloat16(), rtol=0, atol=0)
    assert not torch.equal(after[0], before[0])


def test_cast_cache_leaves_float32_and_training_alone():
    w = torch.nn.Parameter(torch.randn(4, 4))
    cache = CastCache()
    (same,) = cache.get("w", (w,), torch.float32)
    assert same is w
    (cast,) = cache.get("w", (w,), torch.bfloat16)  # grad enabled, requires_grad
    assert cast.requires_grad and cast.grad_fn is not None
    cast.float().sum().backward()
    assert w.grad is not None and torch.equal(w.grad, torch.ones(4, 4))
    with torch.no_grad():
        (cached,) = cache.get("w", (w,), torch.bfloat16)
        assert not cached.requires_grad and cache.get("w", (w,), torch.bfloat16)[0] is cached


def test_cast_cache_derives_once_per_parameter_version():
    """A derived entry (the bf16 PE kernel's split weight) is computed from
    the rounded tensors once, without autograd, and again only after a
    source changes in place."""
    w = torch.nn.Parameter(torch.randn(8, 6))
    cache, calls = CastCache(), []

    def derive(t):
        calls.append(t.dtype)
        return t[:, :4].contiguous()

    first = cache.derive("w/split", (w,), torch.bfloat16, derive)
    assert first.dtype == torch.bfloat16 and not first.requires_grad
    torch.testing.assert_close(first, w.detach()[:, :4].bfloat16(), rtol=0, atol=0)
    assert cache.derive("w/split", (w,), torch.bfloat16, derive) is first
    with torch.no_grad():
        w.mul_(2.0)
    again = cache.derive("w/split", (w,), torch.bfloat16, derive)
    torch.testing.assert_close(again, w.detach()[:, :4].bfloat16(), rtol=0, atol=0)
    assert calls == [torch.bfloat16, torch.bfloat16]


def test_pe_split_operands_match_pallas_in_bf16():
    """The bf16 kernel's operands (``kernels.pe_block_split`` of the module's
    rounded table, weight and bias) against the Pallas wrapper's own split
    (pallas_kernels.py:82-90): W's x columns bit-equal to its w_x, the PE
    term within float32 rounding of its ``pe @ W_pe + b``; and the kernel's
    arithmetic on them (``pe_block_split_plain``) against ``pe_block_pallas``
    in interpret mode: >= 99% of outputs bit-equal, gap <= one bf16 ulp."""
    pe = _perturbed(PositionalEncoding(max_len=S), seed=15)
    x, jx = _bf16_input(B, S, E, seed=16)
    conv, norm = pe[1], pe[2]
    table = pe[0].pe[0, :, :S].T
    sources = (table, conv.weight.view(E, -1), conv.bias)
    split = CastCache().derive("split", sources, torch.bfloat16, kernels.pe_block_split)
    w_x, pe_bias = split
    assert w_x.is_contiguous() and w_x.shape == (E, E) and pe_bias.dtype == torch.float32

    jnp_of = lambda t: jnp.asarray(t.detach().float().numpy())  # noqa: E731
    j_table = jnp.asarray(positional_encoding_table(D, S)).astype(BF16)
    j_kernel = jnp_of(conv.weight[:, :, 0].T).astype(BF16)  # (C_in + D, C_out)
    j_bias = jnp_of(conv.bias).astype(BF16)
    np.testing.assert_array_equal(w_x.float().numpy(),
                                  np.asarray(j_kernel[:E].astype(jnp.float32)).T)
    want_bias = (j_table.astype(jnp.float32) @ j_kernel[E:].astype(jnp.float32)
                 + j_bias.astype(jnp.float32))
    np.testing.assert_allclose(pe_bias.numpy(), np.asarray(want_bias), rtol=1e-6, atol=1e-6)

    scale, shift = (t.detach().bfloat16() for t in (norm.weight, norm.bias))
    got = kernels.pe_block_split_plain(x, split, scale, shift, num_groups=norm.num_groups)
    want = pe_block_pallas(jx, j_table, j_kernel, j_bias, jnp_of(norm.weight).astype(BF16),
                           jnp_of(norm.bias).astype(BF16), num_groups=norm.num_groups,
                           interpret=True)
    assert got.dtype == torch.bfloat16
    assert_bf16_match(got.float().numpy(), want)
