"""Top-k accuracy, confusion matrices and loss means, accumulated on the
device.

Port of the JAX package's ``utils/metrics.py`` (reference
core/utils/metric.py): per-head top-k accuracy, a combined ``all_class``
accuracy (a sample counts only when every head's top-k holds its label),
per-head confusion matrices, and running sums of every loss term. Each
batch adds its percentage over its true rows (rows from ``batch_size`` on
are the loader's padding and count nowhere); ``compute`` divides by the
number of batches consumed and is the one host synchronization.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch


class Metric:
    def __init__(self, cfg, no_batches: int):
        self.topk: List[int] = list(cfg.val.topk)
        self.maxk = max(self.topk)
        self.no_batches = max(no_batches, 1)
        self.updates = 0
        self.num_classes: Dict[str, int] = dict(cfg.model.num_classes)
        self.multi_class = len(self.num_classes) > 1
        self._acc: Dict[str, torch.Tensor] = {}
        self._conf: Dict[str, torch.Tensor] = {}
        self.loss: Dict[str, object] = {key: 0.0 for key in self.num_classes}
        if self.multi_class:
            self.loss["all_class"] = 0.0
        att = cfg.model.attention
        if att.enable and not att.use_fixed:
            for flag, key in (("use_prior", "prior"), ("use_contrast", "contrast"),
                              ("use_entropy", "entropy")):
                if att[flag]:
                    self.loss[key] = 0.0
        self.loss["total"] = 0.0

    def _init_accumulators(self, device: torch.device) -> None:
        k = len(self.topk)
        for key, n in self.num_classes.items():
            self._acc[key] = torch.zeros(k, device=device)
            self._conf[key] = torch.zeros((n, n), device=device)
        if self.multi_class:
            self._acc["all_class"] = torch.zeros(k, device=device)

    @torch.no_grad()
    def update(self, preds: Mapping[str, torch.Tensor], targets: Mapping,
               batch_loss: Mapping[str, torch.Tensor], batch_size: Optional[int] = None) -> None:
        self.updates += 1
        first = preds[next(iter(self.num_classes))]
        if not self._acc:
            self._init_accumulators(first.device)
        rows = first.shape[0]
        true_bs = rows if batch_size is None else int(batch_size)
        mask = torch.arange(rows, device=first.device) < true_bs
        scale = 100.0 / true_bs
        joint = None
        for key in self.num_classes:
            labels = torch.as_tensor(targets["class"][key], device=first.device).long()
            top = preds[key].topk(self.maxk, dim=-1).indices
            within = (top == labels[:, None]).cumsum(dim=1) > 0  # (B, maxk)
            self._conf[key].index_put_((labels, top[:, 0]), mask.float(), accumulate=True)
            hits = torch.stack([(within[:, k - 1] & mask).sum() for k in self.topk])
            self._acc[key] += hits.float() * scale
            joint = within if joint is None else joint & within
        if self.multi_class:
            hits = torch.stack([(joint[:, k - 1] & mask).sum() for k in self.topk])
            self._acc["all_class"] += hits.float() * scale
        for key in self.loss:
            if key in batch_loss:
                self.loss[key] = self.loss[key] + batch_loss[key]

    def compute(self):
        """(loss, accuracy, confusion matrices) as host numbers; the one
        device synchronization of an epoch."""
        if not self._acc:
            self._init_accumulators(torch.device("cpu"))
        denom = self.updates or self.no_batches
        accuracy = {key: [round(float(v) / denom, 2) for v in values.cpu().numpy()]
                    for key, values in self._acc.items()}
        loss = {key: round(float(v) / denom, 5) for key, v in self.loss.items()}
        conf = {key: v.cpu().numpy().astype(np.float64) for key, v in self._conf.items()}
        return loss, accuracy, conf
