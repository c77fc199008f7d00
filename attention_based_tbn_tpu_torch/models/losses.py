"""Losses: per-head classification plus the attention auxiliaries.

Port of the JAX package's ``models/losses.py`` (reference
core/models/model_builder.py:16-22, core/models/model.py:264-334,
core/models/contrast_loss.py):

* classification: cross-entropy or NLL per head, summed;
* prior loss on the attention weights (KL against the data pipeline's
  prior, applied to log-weights; or MSE / smooth-L1);
* contrast loss: sum(off-peak) - sum(peak) under a detached threshold mask;
* entropy of the attention distribution, with a training early stop;
* all three gated to 0 before epoch ``decay_step`` and scaled by their
  multipliers after it.

Every mean takes an optional 0/1 row mask so that a loader's pad rows
count nowhere. The epoch is a host integer, so the ``decay_step`` gate is
a Python branch; the entropy early stop reads the loss on the device
(``torch.where``) and never synchronizes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch

from .tbn import tile_crop_rows


def _row_mean(values: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over every element; with ``mask`` (0/1 per leading row) a
    weighted mean over the unmasked rows only."""
    if mask is None:
        return values.mean()
    mask = mask.float()
    shaped = mask.view(mask.shape + (1,) * (values.dim() - 1))
    denom = mask.sum().clamp_min(1.0) * float(math.prod(values.shape[1:]))
    return (values * shaped).sum() / denom


def cross_entropy(logits, labels, mask=None):
    """torch.nn.CrossEntropyLoss (mean reduction; pad rows masked out)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, labels.long()[:, None])[:, 0]
    return -_row_mean(picked, mask)


def nll_loss(log_probs, labels, mask=None):
    """torch.nn.NLLLoss (mean reduction); expects log-probabilities."""
    picked = log_probs.float().gather(-1, labels.long()[:, None])[:, 0]
    return -_row_mean(picked, mask)


def mse_loss(pred, target, mask=None):
    return _row_mean((pred.float() - target.float()).square(), mask)


def smooth_l1_loss(pred, target, beta: float = 1.0, mask=None):
    diff = (pred.float() - target.float()).abs()
    val = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return _row_mean(val, mask)


def kl_div(log_pred, target, reduction: str = "batchmean", mask=None):
    """torch.nn.KLDivLoss: input is log-probabilities, target probabilities;
    zero-probability targets contribute 0."""
    target = target.float()
    log_pred = log_pred.float()
    pointwise = target * (target.clamp_min(1e-30).log() - log_pred)
    pointwise = torch.where(target > 0, pointwise, torch.zeros_like(pointwise))
    if mask is not None:
        mask = mask.float()
        pointwise = pointwise * mask.view(mask.shape + (1,) * (pointwise.dim() - 1))
        rows = mask.sum().clamp_min(1.0)
    else:
        rows = log_pred.shape[0]
    if reduction == "batchmean":
        return pointwise.sum() / rows
    if reduction == "sum":
        return pointwise.sum()
    if mask is not None:
        return pointwise.sum() / (rows * math.prod(log_pred.shape[1:]))
    return pointwise.mean()


# Head losses by cfg.model.loss_fn: only these two take integer labels (the
# reference's heads hardwire cross-entropy, model.py:294).
CLASSIFICATION_LOSSES = {"crossentropy": cross_entropy, "nll": nll_loss}


def contrast_loss(weights, threshold: float = 0.1, reduction: str = "batchmean",
                  row_mask=None):
    """sum(off-peak) - sum(peak) per row under a detached binary mask
    (reference contrast_loss.py:15-25)."""
    w = weights.float()
    mask = (w >= threshold).float().detach()
    loss = (w * (1.0 - mask) - w * mask).sum(dim=1)
    if reduction in ("mean", "batchmean"):
        return _row_mean(loss, row_mask)
    if row_mask is not None:
        return (loss * row_mask.float()).sum()
    return loss.sum()


def attention_entropy(weights, eps: float = 1e-6, row_mask=None):
    """Mean entropy of the renormalized attention rows, as
    Categorical(probs=wts + eps).entropy().mean() (model.py:324)."""
    p = weights.float() + eps
    p = p / p.sum(dim=-1, keepdim=True)
    return _row_mean(-(p * p.log()).sum(dim=-1), row_mask)


def prior_loss(weights, prior, wt_loss: str = "kl", reduction: str = "batchmean",
               row_mask=None):
    """Prior supervision of the attention weights (model.py:312-319); for
    "kl" the input is log(wts + 1e-7) and the prior the target."""
    if wt_loss == "kl":
        return kl_div((weights.float() + 1e-7).log(), prior, reduction, mask=row_mask)
    if wt_loss == "mse":
        return mse_loss(weights, prior, mask=row_mask)
    if wt_loss == "smoothl1":
        return smooth_l1_loss(weights, prior, mask=row_mask)
    raise ValueError(f"Unsupported wt_loss {wt_loss!r}")


def tbn_loss(preds: Mapping[str, torch.Tensor], targets: Mapping[str, Any], cfg,
             epoch: int = 0, train: bool = True,
             attention_weights: Optional[torch.Tensor] = None,
             true_batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The loss dict: one entry per head, ``all_class``, the active
    attention terms (``prior``, ``contrast``, ``entropy``) and ``total``.

    ``targets``: {"class": {head: (B,) int labels}, "weights": (B, N, W, 1)
    priors when ``use_prior``}. ``true_batch``: rows from it on are padding
    and are left out of every mean (None: all rows are real)."""
    att_cfg = cfg.model.attention
    try:
        loss_fn = CLASSIFICATION_LOSSES[cfg.model.loss_fn]
    except KeyError:
        raise ValueError(
            f"model.loss_fn={cfg.model.loss_fn!r} has no integer-label head semantics; it "
            "is a prior-loss (model.attention.wt_loss) option"
        ) from None

    loss: Dict[str, torch.Tensor] = {}
    all_class = 0.0
    sample_mask = None
    for key, labels in targets["class"].items():
        logits = preds[key]
        labels = torch.as_tensor(labels, device=logits.device)
        if true_batch is not None and sample_mask is None:
            rows = torch.arange(logits.shape[0], device=logits.device)
            sample_mask = (rows < true_batch).float()
        loss[key] = loss_fn(logits, labels, mask=sample_mask)
        all_class = all_class + loss[key]
    loss["all_class"] = all_class
    total = all_class

    if att_cfg.enable and not att_cfg.use_fixed and attention_weights is not None:
        # aux losses switch on at epoch decay_step (1-indexed, model.py:301)
        gate = 0.0 if (train and epoch + 1 < att_cfg.decay_step) else 1.0
        wts = attention_weights
        if wts.dim() == 3:  # (B*, 1, S) from MHA
            wts = wts[:, 0, :]
        # attention rows are (batch, segments) folded batch-major
        wt_mask = None
        if sample_mask is not None:
            wt_mask = sample_mask.repeat_interleave(wts.shape[0] // sample_mask.shape[0])

        if att_cfg.use_prior:
            target_wts = torch.as_tensor(targets["weights"], device=wts.device)
            b, n = target_wts.shape[:2]
            prior = target_wts.reshape(b * n, -1)
            if wts.shape[0] != b * n:  # 10-crop rows: tile the prior the same way
                prior = tile_crop_rows(prior, b, wts.shape[0] // (b * n))
            loss["prior"] = prior_loss(wts, prior, att_cfg.wt_loss, att_cfg.loss_reduction,
                                       row_mask=wt_mask)
            total = total + gate * att_cfg.wt_decay * loss["prior"]
        if att_cfg.use_contrast:
            loss["contrast"] = contrast_loss(wts, att_cfg.contrast_thresh,
                                             att_cfg.loss_reduction, row_mask=wt_mask)
            total = total + gate * att_cfg.contrast_decay * loss["contrast"]
        if att_cfg.use_entropy:
            loss["entropy"] = attention_entropy(wts, row_mask=wt_mask)
            # early stop: once entropy sinks below the threshold, drop the term
            ent_gate = torch.ones((), device=wts.device)
            if train and gate > 0:
                ent_gate = torch.where(loss["entropy"] < att_cfg.entropy_thresh,
                                       torch.zeros_like(ent_gate), ent_gate)
            total = total + gate * ent_gate * att_cfg.entropy_decay * loss["entropy"]

    loss["total"] = total
    return loss
