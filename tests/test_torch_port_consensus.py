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
    feats, weights, biases = _case(seed=3)
    bf = torch.from_numpy(feats).bfloat16()
    got = kernels.consensus_heads_plain(bf, [torch.from_numpy(w) for w in weights],
                                        [torch.from_numpy(v) for v in biases])
    want = kernels.consensus_heads_plain(bf.float(), [torch.from_numpy(w) for w in weights],
                                         [torch.from_numpy(v) for v in biases])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


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
    w = [torch.from_numpy(a).cuda() for a in weights]
    v = [torch.from_numpy(a).cuda() for a in biases]
    before = kernels.consensus_heads.launches
    got = kernels.consensus_heads(x, w, v)
    assert kernels.consensus_heads.launches == before + 1
    for g, want in zip(got, kernels.consensus_heads_plain(x, w, v)):
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-5)
