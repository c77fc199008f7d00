"""Training-mode modules of the port against the JAX package's, and the
properties of their noise.

* BatchNorm with live statistics (``layers.batch_norm_train``) against JAX
  ``TorchBatchNorm``: output and running statistics, with and without a
  pad-row mask, and the conv bias recorded only in the running mean.
  Tolerance rtol 1e-5 / atol 1e-6 (float32 sums in another order).
* A BN-Inception tower in training against JAX ``BNInception.apply(train=
  True, mutable=["batch_stats"])``: features, new running statistics and
  parameter gradients. Tolerances from a measurement: with random weights
  the train-mode backward of the ~60-layer tower loses ~1.3% of the
  gradient's digits in float32 between two exact JAX lowerings of the same
  math (merged vs separate 1x1 convolutions: global relative L2 1.28e-2;
  the port 1.48e-2), so gradients are held at a global relative L2 of 3e-2
  and 5e-2 per tensor; features at 1e-3 of their largest value (single-pass
  variances of the small late maps; JAX-vs-JAX 2.4e-5, the port 1.2e-4);
  running statistics at 1e-3 of each tensor's largest value (port 1.4e-4).
* PE + MHA, UniModal and Prototype attention, Fusion and the classifier in
  training with dropout rates 0 and gumbel off (the two frameworks' noise
  streams cannot match): outputs and gradients of parameters and inputs,
  rtol 1e-4 with atol 1e-5 of the largest value (summation order only).
* Noise: dropout keeps its rate and scales by 1/(1-p); the hard
  gumbel-softmax is one-hot forward with the softmax's gradient; MHA
  returns the dropped weights; audio dropout drops when u > p.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.models.attention import MultiheadAttention as JaxMHA
from attention_based_tbn_tpu.models.attention import PositionalEncoding as JaxPE
from attention_based_tbn_tpu.models.attention import PrototypeAttention as JaxProto
from attention_based_tbn_tpu.models.attention import UniModalAttention as JaxUni
from attention_based_tbn_tpu.models.bn_inception import BNInception as JaxBNInception
from attention_based_tbn_tpu.models.heads import Classifier as JaxClassifier
from attention_based_tbn_tpu.models.heads import Fusion as JaxFusion
from attention_based_tbn_tpu.models.layers import TorchBatchNorm as JaxBatchNorm
from attention_based_tbn_tpu_torch.models.attention import (
    MHAttention, PositionalEncoding, PrototypeAttention, UniModalAttention, gumbel_softmax,
)
from attention_based_tbn_tpu_torch.models.bn_inception import BNInception
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.models.heads import Classifier, Fusion
from attention_based_tbn_tpu_torch.models.layers import batch_norm_train, dropout
from attention_based_tbn_tpu_torch.ops import kernels
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from test_torch_port_towers import _randomize_port
from torch_port_helpers import configs, make_batch, one_torch_thread  # noqa: F401

RGB_MEAN = np.array([0.408, 0.459, 0.502], np.float32)


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rtol=1e-4, scale=1e-5, msg=""):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * max(np.abs(want).max(), 1e-12), err_msg=msg)


# ------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("mask", [None, [1, 1, 0, 1, 0]])
def test_batch_norm_train_matches_jax(mask):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 6, 7, 16)) * 2 + 0.5).astype(np.float32)  # NHWC
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(0, 0.1, 16).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 16).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    offset = rng.normal(0, 0.3, 16).astype(np.float32)
    row_mask = None if mask is None else np.asarray(mask, np.float32)

    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    want, mutated = JaxBatchNorm().apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x), use_running_average=False,
        mean_offset=jnp.asarray(offset),
        row_mask=None if row_mask is None else jnp.asarray(row_mask), mutable=["batch_stats"])

    bn = torch.nn.BatchNorm2d(16)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    got = batch_norm_train(torch.from_numpy(x).permute(0, 3, 1, 2), bn, torch.from_numpy(offset),
                           None if row_mask is None else torch.from_numpy(row_mask))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), mutated["batch_stats"]["mean"], **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), mutated["batch_stats"]["var"], **tol)


def test_masked_rows_change_nothing():
    """Pad rows, whatever they hold, move neither the output of the real
    rows nor the running statistics."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, 5, 5, generator=gen)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    outs, stats = [], []
    for pad in (x[3], torch.randn(8, 5, 5, generator=gen) * 100):
        bn = torch.nn.BatchNorm2d(8)
        outs.append(batch_norm_train(torch.cat([x[:3], pad[None]]), bn, row_mask=mask)[:3])
        stats.append((bn.running_mean.clone(), bn.running_var.clone()))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    torch.testing.assert_close(stats[0], stats[1], rtol=0, atol=0)
    bn = torch.nn.BatchNorm2d(8)
    torch.testing.assert_close(batch_norm_train(x[:3], bn), outs[0], rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- tower


def test_tower_train_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 255, (4, 96, 96, 3)).astype(np.uint8)
    scale, offset = np.full(3, 1 / 255.0, np.float32), -RGB_MEAN
    mask = np.array([1, 1, 1, 0], np.float32)
    tower = BNInception(3)
    tower.reset_parameters(torch.Generator().manual_seed(0))
    _randomize_port(tower, seed=1)
    variables = state_dict_to_jax({f"Base_X.{k}": v.clone() for k, v in tower.state_dict().items()})
    variables = {k: v["Base_X"] for k, v in variables.items()}

    tower.train()
    feat = tower(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32,
                 torch.from_numpy(scale), torch.from_numpy(offset), torch.from_numpy(mask))
    g = rng.standard_normal(feat.shape).astype(np.float32)
    (feat * torch.from_numpy(g)).sum().backward()
    got_grads = _leaves(state_dict_to_jax({
        f"Base_X.{n}": p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in tower.named_parameters()})["params"]["Base_X"])
    got_stats = _leaves(state_dict_to_jax({
        f"Base_X.{k}": v for k, v in tower.state_dict().items()})["batch_stats"]["Base_X"])

    jax_tower = JaxBNInception()

    def loss(params):
        out, mutated = jax_tower.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x), True,
            jnp.asarray(mask), jnp.asarray(scale), jnp.asarray(offset), mutable=["batch_stats"])
        return (out * g).sum(), (out, mutated["batch_stats"])

    grads, (want_feat, want_stats) = jax.jit(jax.grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, variables["params"]))
    _close(feat.detach().numpy(), np.asarray(want_feat), rtol=0, scale=1e-3, msg="features")
    for key, want in _leaves(want_stats).items():
        _close(got_stats[key], want, rtol=0, scale=1e-3, msg=key)
    want_grads = _leaves(grads)
    assert set(got_grads) == set(want_grads)
    norm = lambda d: np.sqrt(sum(float(np.square(v).sum()) for v in d.values()))  # noqa: E731
    total = norm(want_grads)
    assert norm({k: got_grads[k] - w for k, w in want_grads.items()}) <= 3e-2 * total
    for key, want in want_grads.items():
        floor = 1e-6 * total  # conv biases: exactly zero on both sides
        assert np.linalg.norm(got_grads[key] - want) <= 5e-2 * np.linalg.norm(want) + floor, key


# --------------------------------------------------- attention and heads


def _port_grads(module, prefix):
    return {f"{prefix}.{n}": p.grad for n, p in module.named_parameters()}


def _to_jax(state, name):
    return jax.tree.map(jnp.asarray, state_dict_to_jax(state)["params"][name])


def _perturb(module, seed):
    """Seeded init plus random biases and norm affines (not the identity)."""
    gen = torch.Generator().manual_seed(seed)
    module.reset_parameters(gen)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias") or (p.dim() == 1 and "weight" in name):
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)


def test_pe_and_mha_train_match_jax():
    rng = np.random.default_rng(1)
    b, s, e = 5, 8, 1024
    feature = rng.standard_normal((b, s, e)).astype(np.float32)
    query = rng.standard_normal((b, e)).astype(np.float32)
    g_out = rng.standard_normal((b, e)).astype(np.float32)
    g_wts = rng.standard_normal((b, s)).astype(np.float32)
    pe, mha = PositionalEncoding(max_len=s), MHAttention(e, 4, dropout_rate=0.0)
    _perturb(pe, 2)
    _perturb(mha, 3)
    state = {**{f"pe.{k}": v for k, v in pe.state_dict().items()},
             **{f"attention_layer.{k}": v for k, v in mha.state_dict().items()}}
    params = {"pe": _to_jax(state, "pe"), "att": _to_jax(state, "attention_layer")}

    pe.train()
    mha.train()
    kernels.reset_launch_counts()
    ft = torch.from_numpy(feature).requires_grad_(True)
    qt = torch.from_numpy(query).requires_grad_(True)
    out, wts = mha(qt, pe(ft, use_kernels=True), True, torch.Generator())
    ((out * torch.from_numpy(g_out)).sum() + (wts[:, 0] * torch.from_numpy(g_wts)).sum()).backward()
    assert kernels.pe_block.launches == kernels.mha.launches == 0  # train: plain compositions

    def loss(params, feature, query):
        seq = JaxPE(dim_size=10, max_len=s, out_features=e).apply(
            {"params": params["pe"]}, feature, train=True)
        o, w = JaxMHA(embed_dim=e, num_heads=4, dropout_rate=0.0).apply(
            {"params": params["att"]}, query[:, None], seq, seq, train=True)
        return (o[:, 0] * g_out).sum() + (w[:, 0] * g_wts).sum(), (o[:, 0], w[:, 0])

    (gp, gf, gq), (want_out, want_wts) = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(feature), jnp.asarray(query))
    _close(out.detach().numpy(), np.asarray(want_out), msg="out")
    _close(wts[:, 0].detach().numpy(), np.asarray(want_wts), msg="weights")
    _close(ft.grad.numpy(), np.asarray(gf), msg="d feature")
    _close(qt.grad.numpy(), np.asarray(gq), msg="d query")
    grads = {**_port_grads(pe, "pe"), **_port_grads(mha, "attention_layer")}
    got = state_dict_to_jax({**state, **grads})["params"]
    for name, jname in (("pe", "pe"), ("attention_layer", "att")):
        want = _leaves(gp[jname])
        for key, w in _leaves(got[name]).items():
            if key.endswith("k_proj/bias"):  # mathematically zero (softmax shift)
                assert np.abs(w).max() < 1e-6 * np.abs(want["k_proj/kernel"]).max()
                continue
            _close(w, want[key], msg=f"{name}/{key}")


@pytest.mark.parametrize("kind", ["unimodal", "proto"])
def test_unimodal_and_proto_train_match_jax(kind):
    rng = np.random.default_rng(2)
    b, s = 6, 8
    rgb = rng.standard_normal((b, 1024)).astype(np.float32)
    audio = rng.standard_normal((b, s, 1024)).astype(np.float32)
    g_out = rng.standard_normal((b, 1024)).astype(np.float32)
    g_wts = rng.standard_normal((b, s)).astype(np.float32)
    cls, jcls = (UniModalAttention, JaxUni) if kind == "unimodal" else (PrototypeAttention,
                                                                         JaxProto)
    module = cls(s, use_gumbel=False)
    _perturb(module, 4)
    state = {f"attention_layer.{k}": v for k, v in module.state_dict().items()}
    params = _to_jax(state, "attention_layer")
    module.train()
    rt = torch.from_numpy(rgb).requires_grad_(True)
    at = torch.from_numpy(audio).requires_grad_(True)
    out, wts = module(rt, at, torch.Generator())
    ((out * torch.from_numpy(g_out)).sum() + (wts * torch.from_numpy(g_wts)).sum()).backward()

    def loss(params, rgb, audio):
        o, w = jcls(win_size=s, use_gumbel=False).apply({"params": params}, rgb, audio,
                                                       train=True)
        return (o * g_out).sum() + (w * g_wts).sum(), (o, w)

    (gp, gr, ga), (want_out, want_wts) = jax.grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(rgb), jnp.asarray(audio))
    _close(out.detach().numpy(), np.asarray(want_out), msg="out")
    _close(wts.detach().numpy(), np.asarray(want_wts), msg="weights")
    _close(rt.grad.numpy(), np.asarray(gr), msg="d rgb")
    _close(at.grad.numpy(), np.asarray(ga), msg="d audio")
    got = state_dict_to_jax({**state, **_port_grads(module, "attention_layer")})["params"]
    want = _leaves(gp)
    for key, w in _leaves(got["attention_layer"]).items():
        _close(w, want[key], msg=key)


def test_fusion_and_classifier_train_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 2048)).astype(np.float32)
    g = {"verb": rng.standard_normal((6, 125)).astype(np.float32),
         "noun": rng.standard_normal((6, 352)).astype(np.float32)}
    fusion, classifier = Fusion(2048, 512, dropout_rate=0.0), Classifier(512, {"verb": 125,
                                                                               "noun": 352})
    _perturb(fusion, 5)
    _perturb(classifier, 6)
    state = {**{f"fusion.{k}": v for k, v in fusion.state_dict().items()},
             **{f"classifier.{k}": v for k, v in classifier.state_dict().items()}}
    params = {"fusion": _to_jax(state, "fusion"), "classifier": _to_jax(state, "classifier")}
    fusion.train()
    classifier.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = classifier(fusion(xt, torch.float32, torch.Generator()), torch.float32)
    sum((v * torch.from_numpy(g[k])).sum() for k, v in logits.items()).backward()

    def loss(params, x):
        y = JaxFusion(512, dropout=0.0).apply({"params": params["fusion"]}, x, train=True)
        out = JaxClassifier({"verb": 125, "noun": 352}).apply({"params": params["classifier"]}, y)
        return sum((v * g[k]).sum() for k, v in out.items()), out

    (gp, gx), want = jax.grad(loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    for key in ("verb", "noun"):
        _close(logits[key].detach().numpy(), np.asarray(want[key]), msg=key)
    _close(xt.grad.numpy(), np.asarray(gx), msg="d x")
    grads = {**_port_grads(fusion, "fusion"), **_port_grads(classifier, "classifier")}
    got = state_dict_to_jax({**state, **grads})["params"]
    for name in ("fusion", "classifier"):
        want_leaves = _leaves(gp[name])
        for key, w in _leaves(got[name]).items():
            _close(w, want_leaves[key], msg=f"{name}/{key}")


# ----------------------------------------------------------------- noise


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.5])
def test_dropout_keeps_rate_and_scale(rate):
    x = torch.rand(200_000) + 1.0  # never zero
    y = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(1 - kept.float().mean().item() - rate) < 5e-3
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=0, atol=0)
    again = dropout(x, rate, torch.Generator().manual_seed(0))
    torch.testing.assert_close(y, again, rtol=0, atol=0)  # the generator is the only noise
    assert (dropout(x, 1.0, torch.Generator()) == 0).all()


def test_gumbel_softmax_is_one_hot_with_the_softmax_gradient():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((64, 9)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 9)).astype(np.float32))
    lt = logits.clone().requires_grad_(True)
    y = gumbel_softmax(lt, torch.Generator().manual_seed(1))
    (y * w).sum().backward()
    # the same draws, by hand: Gumbel(0, 1) = -log(Exponential(1))
    gumbels = -torch.empty(logits.shape).exponential_(
        generator=torch.Generator().manual_seed(1)).log()
    ls = logits.clone().requires_grad_(True)
    soft = torch.softmax(ls + gumbels, dim=-1)
    (soft * w).sum().backward()
    # one-hot up to the rounding of 1 + y - y
    one_hot = torch.nn.functional.one_hot(soft.argmax(-1), 9).float()
    torch.testing.assert_close(y.detach(), one_hot, rtol=0, atol=1e-6)
    torch.testing.assert_close(lt.grad, ls.grad, rtol=1e-6, atol=1e-7)


def test_mha_returns_the_dropped_weights():
    """With dropout, the weights MHA returns are the head mean of the
    dropped and rescaled probabilities, as torch and the JAX package return
    them; the output uses the same dropped probabilities."""
    gen = torch.Generator().manual_seed(0)
    b, s, e, h = 4, 8, 64, 4
    q, kv = torch.randn(b, e, generator=gen), torch.randn(b, s, e, generator=gen)
    w = [torch.randn(3 * e, e, generator=gen) * 0.1, torch.randn(3 * e, generator=gen) * 0.1,
         torch.randn(e, e, generator=gen) * 0.1, torch.randn(e, generator=gen) * 0.1]
    mask = (torch.rand(b, h, s, generator=gen) > 0.5).float() * 2.0
    seen = {}

    def drop(p):
        seen["probs"] = p
        return p * mask

    out, wts = kernels.mha_plain(q, kv, *w, num_heads=h, drop=drop)
    torch.testing.assert_close(wts, (seen["probs"] * mask).mean(dim=1))
    clean_out, clean_wts = kernels.mha_plain(q, kv, *w, num_heads=h)
    torch.testing.assert_close(clean_wts, seen["probs"].mean(dim=1))
    assert not torch.allclose(out, clean_out)


def test_audio_dropout_polarity():
    """One draw u per step; the reference zeroes the audio feature when
    u > p (p acts as the keep probability)."""
    cfg, _ = configs(["data.flow.enable=false", "model.attention.attn_dropout=0",
                      "model.fusion_dropout=0", "data.audio.dropout=0.3"])
    model = build_model(cfg, get_modality(cfg), device="cpu").train()
    assert model.spec.audio_dropout == 0.3
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, b=2).items()}
    no_drop = dataclasses.replace(model.spec, audio_dropout=0.0)
    outcomes = set()
    for seed in range(6):
        u = torch.rand((), generator=torch.Generator().manual_seed(seed)).item()
        with torch.no_grad():
            spec = model.spec
            got = model(batch, generator=torch.Generator().manual_seed(seed))
            model.spec = no_drop
            clean = model(batch, generator=torch.Generator().manual_seed(seed))
            model.spec = spec
        dropped = not torch.allclose(got["verb"], clean["verb"])
        assert dropped == (u > 0.3), (seed, u)
        outcomes.add(dropped)
    assert outcomes == {True, False}
