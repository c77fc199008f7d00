"""The port's losses against the JAX package's ``models/losses.py`` on
seeded logits and attention weights: every loss with and without a pad-row
mask, and ``tbn_loss`` with the prior / contrast / entropy terms, the
``decay_step`` gate, the entropy early stop and the 10-crop prior tiling;
plus the gradient of ``tbn_loss``. Tolerance rtol 1e-5 / atol 1e-6 (float32
reductions in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.models import losses as jax_losses
from attention_based_tbn_tpu_torch.models import losses
from torch_port_helpers import configs, one_torch_thread  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-5, atol=1e-6)
MASKS = [None, np.array([1, 1, 0, 1, 0, 0], np.float32)]


def _rng_case(seed, rows=6):
    rng = np.random.default_rng(seed)
    wts = rng.random((rows, 8)).astype(np.float32)
    return dict(
        logits=(rng.standard_normal((rows, 11)) * 2).astype(np.float32),
        labels=rng.integers(0, 11, rows).astype(np.int32),
        pred=rng.standard_normal((rows, 5)).astype(np.float32),
        target=(rng.standard_normal((rows, 5)) * 2).astype(np.float32),
        weights=wts / wts.sum(-1, keepdims=True),
        prior=rng.dirichlet(np.ones(8), rows).astype(np.float32),
    )


def _both(fn_name, args, kwargs=None):
    kwargs = kwargs or {}
    want = getattr(jax_losses, fn_name)(
        *[jnp.asarray(a) for a in args],
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()})
    got = getattr(losses, fn_name)(
        *[torch.from_numpy(a) for a in args],
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()})
    return float(got), float(want)


@pytest.mark.parametrize("masked", [False, True])
def test_elementwise_losses_match_jax(masked):
    c = _rng_case(0)
    m = MASKS[masked]
    logp = np.array(jax.nn.log_softmax(c["logits"]))  # a writable copy for torch
    cases = [
        ("cross_entropy", (c["logits"], c["labels"]), {"mask": m}),
        ("nll_loss", (logp, c["labels"]), {"mask": m}),
        ("mse_loss", (c["pred"], c["target"]), {"mask": m}),
        ("smooth_l1_loss", (c["pred"], c["target"]), {"mask": m, "beta": 1.0}),
        ("contrast_loss", (c["weights"],), {"row_mask": m, "threshold": 0.15}),
        ("attention_entropy", (c["weights"],), {"row_mask": m}),
    ]
    for reduction in ("batchmean", "sum", "mean"):
        cases.append(("kl_div", (np.log(c["weights"] + 1e-7), c["prior"]),
                      {"reduction": reduction, "mask": m}))
        cases.append(("contrast_loss", (c["weights"],), {"reduction": reduction, "row_mask": m}))
    for wt_loss in ("kl", "mse", "smoothl1"):
        cases.append(("prior_loss", (c["weights"], c["prior"]),
                      {"wt_loss": wt_loss, "row_mask": m}))
    for name, args, kwargs in cases:
        got, want = _both(name, args, kwargs)
        np.testing.assert_allclose(got, want, err_msg=f"{name} {kwargs}", **TOL)


def test_kl_div_ignores_zero_targets():
    prior = np.array([[0.5, 0.5, 0.0], [1.0, 0.0, 0.0]], np.float32)
    log_pred = np.log(np.full((2, 3), 1 / 3, np.float32))
    got, want = _both("kl_div", (log_pred, prior))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got)


ATT = ["model.attention.use_prior=true", "model.attention.use_contrast=true",
       "model.attention.use_entropy=true"]


def _tbn_case(seed, b=4, n=3, crops=1):
    rng = np.random.default_rng(seed)
    wts = rng.random((b * n * crops, 1, 8)).astype(np.float32) ** 3
    preds = {"verb": rng.standard_normal((b, 125)).astype(np.float32),
             "noun": rng.standard_normal((b, 352)).astype(np.float32)}
    targets = {"class": {"verb": rng.integers(0, 125, b).astype(np.int32),
                         "noun": rng.integers(0, 352, b).astype(np.int32)},
               "weights": rng.dirichlet(np.ones(8), (b, n)).astype(np.float32)[..., None]}
    return preds, targets, wts / wts.sum(-1, keepdims=True)


def _tbn_both(overrides, epoch, train, true_batch, crops=1, seed=1):
    cfg, jcfg = configs(ATT + list(overrides))
    preds, targets, wts = _tbn_case(seed, crops=crops)
    want = jax_losses.tbn_loss(
        jax.tree.map(jnp.asarray, preds), jax.tree.map(jnp.asarray, targets), jcfg,
        epoch=epoch, train=train, attention_weights=jnp.asarray(wts), true_batch=true_batch)
    got = losses.tbn_loss(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        {"class": {k: torch.from_numpy(v) for k, v in targets["class"].items()},
         "weights": torch.from_numpy(targets["weights"])},
        cfg, epoch=epoch, train=train, attention_weights=torch.from_numpy(wts),
        true_batch=true_batch)
    return {k: float(v) for k, v in got.items()}, {k: float(v) for k, v in want.items()}


@pytest.mark.parametrize("epoch,train,true_batch,thresh", [
    (0, True, None, 0.2),    # before decay_step: aux terms gated off
    (9, True, None, 0.2),    # epoch + 1 == decay_step: on
    (12, True, 3, 0.2),      # on, with a pad row masked
    (12, True, 3, 5.0),      # entropy under the threshold: early stop
    (0, False, 2, 5.0),      # eval: no gate, no early stop
])
def test_tbn_loss_matches_jax(epoch, train, true_batch, thresh):
    got, want = _tbn_both([f"model.attention.entropy_thresh={thresh}"], epoch, train, true_batch)
    assert set(got) == set(want) == {"verb", "noun", "all_class", "prior", "contrast",
                                     "entropy", "total"}
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_tbn_loss_gate_and_early_stop_change_the_total():
    gated, _ = _tbn_both([], 0, True, None)
    on, _ = _tbn_both([], 12, True, None)
    stopped, _ = _tbn_both(["model.attention.entropy_thresh=5.0"], 12, True, None)
    assert gated["total"] == pytest.approx(gated["all_class"], rel=1e-6)
    decay = 0.25  # wt_decay = contrast_decay = entropy_decay (defaults)
    assert on["total"] == pytest.approx(
        on["all_class"] + decay * (on["prior"] + on["contrast"] + on["entropy"]), rel=1e-5)
    assert stopped["total"] == pytest.approx(
        stopped["all_class"] + decay * (stopped["prior"] + stopped["contrast"]), rel=1e-5)


def test_tbn_loss_tiles_the_prior_for_ten_crop_rows():
    got, want = _tbn_both([], 12, False, None, crops=10)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_tbn_loss_gradient_matches_jax():
    cfg, jcfg = configs(ATT)
    preds, targets, wts = _tbn_case(2)

    def jax_total(p, w):
        return jax_losses.tbn_loss(p, jax.tree.map(jnp.asarray, targets), jcfg, epoch=12,
                                   attention_weights=w, true_batch=3)["total"]

    gp, gw = jax.grad(jax_total, argnums=(0, 1))(jax.tree.map(jnp.asarray, preds),
                                                 jnp.asarray(wts))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in preds.items()}
    tw = torch.from_numpy(wts).requires_grad_(True)
    losses.tbn_loss(tp, {"class": {k: torch.from_numpy(v) for k, v in targets["class"].items()},
                         "weights": torch.from_numpy(targets["weights"])},
                    cfg, epoch=12, attention_weights=tw, true_batch=3)["total"].backward()
    for key in preds:
        np.testing.assert_allclose(tp[key].grad.numpy(), np.asarray(gp[key]), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-5, atol=1e-5)


def test_unknown_head_loss_raises():
    cfg, _ = configs(["model.loss_fn=mse"])
    preds, targets, _ = _tbn_case(3)
    with pytest.raises(ValueError, match="loss_fn"):
        losses.tbn_loss({k: torch.from_numpy(v) for k, v in preds.items()}, targets, cfg)
