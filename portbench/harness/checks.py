"""The numbers that decide ``correct``, and their judgement against the
cell's limits (``portbench/limits/<cell>.json``).

Serving: every request the window completed is held against the
reference's outputs for its input: the relative RMSE of each output (the
logits of each head together, the attention weights), the worst request's.

Training: the reference follows the program's first steps from the same
weights, batches and noise seed. Each step's total loss is compared
(relative gap) and its logits (rel-RMSE of the heads' logits of every
clip of the global batch, the worst step's; a row the program left out
counts as zero); then, leaf by leaf, the norm of the first gradient as the
optimizer took it (its momentum after one step) and the norm of each
leaf's change over the checked steps: the gap between the program's norm
and the reference's, over the larger of the reference's norm of that leaf
and of the median leaf, each leaf's gap and the worst and median over the
leaves. A leaf whose reference gradient is under a thousandth of the
median leaf's (a conv bias in front of BatchNorm: nought to rounding) is
left out of both; the BatchNorm running statistics' changes are taken
apart (``stats_change_gap_*``). ``clips_missing`` counts the clips of a
checked step's batch that the step returned no logits for (exact). The
whole first gradient of Fusion and the heads, which BatchNorm does not
amplify, is held as it is (rel-RMSE, ``head_grad_rel_rmse``; the heads
alone, ``classifier_grad_rel_rmse``, and their biases alone,
``classifier_bias_grad_rel_rmse``): a step that returns every row but
takes its loss over part of them moves these, not the norms.
Which of these the cell's limits hold, and why the others are reported
only, is in PERF.md.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np

from . import stats

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's reference gradient norm


def serve_numbers(completed: Iterable[Tuple[int, dict]], reference: Mapping[int, dict],
                  heads: List[str]) -> Dict[str, float]:
    """``completed``: (input index, outputs) of each request; ``reference``:
    {input index: outputs}. Returns {"logits_rel_rmse": worst, and
    "weights_rel_rmse" where the model returns weights}."""
    worst: Dict[str, float] = {}
    for index, out in completed:
        want = reference[index]
        got_logits = np.concatenate([np.asarray(out[h]).ravel() for h in heads])
        want_logits = np.concatenate([np.asarray(want[h]).ravel() for h in heads])
        pairs = {"logits_rel_rmse": (got_logits, want_logits)}
        if "weights" in want:
            pairs["weights_rel_rmse"] = (out["weights"], want["weights"])
        for name, (got, exp) in pairs.items():
            worst[name] = max(worst.get(name, 0.0), stats.rel_rmse(got, exp))
    return worst


def _leaf_gaps(got: Mapping[str, float], want: Mapping[str, float],
               leaves: List[str]) -> List[Tuple[float, str]]:
    """(gap, leaf) of every leaf, the worst first; a leaf the program lacks
    reads as not moved."""
    floor = statistics.median(want[k] for k in leaves)
    return sorted(((abs(got.get(k, 0.0) - want[k]) / max(want[k], floor, 1e-30), k)
                   for k in leaves), reverse=True)


def _rows_rel_rmse(got, want) -> float:
    """rel-RMSE of ``got`` against ``want``; rows that ``got`` lacks (or
    has beyond ``want``'s) count as zeros on the other side."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rows = max(len(got), len(want))
    pad = lambda a: np.concatenate([a, np.zeros((rows - len(a),) + a.shape[1:])])  # noqa: E731
    return stats.rel_rmse(pad(got), pad(want))


def _grads_rel_rmse(got: Mapping[str, object], want: Mapping[str, object],
                    leaves: List[str]) -> float:
    """rel-RMSE of the leaves' gradients laid end to end; a leaf the program
    lacks reads as zeros."""
    want_all = [np.asarray(want[k], np.float64).ravel() for k in leaves]
    got_all = [np.asarray(got[k], np.float64).ravel() if k in got else np.zeros_like(w)
               for k, w in zip(leaves, want_all)]
    return stats.rel_rmse(np.concatenate(got_all), np.concatenate(want_all))


def train_numbers(port: dict, ref: dict) -> Tuple[Dict[str, float], Dict[str, list]]:
    """``port`` and ``ref``: {"losses": [total per step], "logits": [{head:
    (clips, classes)} per step], "grad_norms": {leaf: norm}, "head_grads":
    {Fusion's and the heads' leaf: first gradient}, "change_norms": {leaf:
    norm}} (the reference's grad_norms cover every
    trainable leaf; its change_norms those and the running statistics).
    Returns the numbers and, for each leaf gap, its five worst leaves as
    [gap, leaf]."""
    losses = [abs(a - b) / abs(b) for a, b in zip(port["losses"], ref["losses"])]
    heads = sorted(ref["logits"][0])
    logits, missing = [], 0
    for got, want in zip(port["logits"], ref["logits"]):
        got = np.concatenate([np.asarray(got[h]) for h in heads], axis=1)
        want = np.concatenate([np.asarray(want[h]) for h in heads], axis=1)
        logits.append(_rows_rel_rmse(got, want))
        missing = max(missing, abs(len(want) - len(got)))
    grads = ref["grad_norms"]
    median = statistics.median(grads.values())
    kept = [k for k, v in grads.items() if v >= NEGLIGIBLE_GRAD * median]
    statistics_leaves = [k for k in ref["change_norms"] if k not in grads]
    gaps = {"grad_norm_gap": _leaf_gaps(port["grad_norms"], grads, kept),
            "change_norm_gap": _leaf_gaps(port["change_norms"], ref["change_norms"], kept),
            "stats_change_gap": _leaf_gaps(port["change_norms"], ref["change_norms"],
                                           statistics_leaves)}
    numbers = {"loss_rel_gap": max(losses), "loss_rel_gap_first": losses[0],
               "logits_rel_rmse": max(logits), "logits_rel_rmse_first": logits[0],
               "clips_missing": float(missing)}
    heads = sorted(ref["head_grads"])
    classifier = [k for k in heads if k.startswith("classifier.")]
    for name, leaves in (("head_grad_rel_rmse", heads), ("classifier_grad_rel_rmse", classifier),
                         ("classifier_bias_grad_rel_rmse",
                          [k for k in classifier if k.endswith(".bias")])):
        numbers[name] = _grads_rel_rmse(port["head_grads"], ref["head_grads"], leaves)
    for name, leaf_gaps in gaps.items():
        values = [gap for gap, _ in leaf_gaps]
        numbers[f"{name}_worst"] = values[0]
        numbers[f"{name}_median"] = statistics.median(values)
    return numbers, {name: [list(g) for g in worst[:5]] for name, worst in gaps.items()}


def judge(numbers: Mapping[str, float], limits: Mapping[str, dict]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): correct when every limited
    number is present, finite and at or under its limit."""
    checks, correct = {}, True
    for name, entry in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": entry["limit"]}
        if value is None or not np.isfinite(value) or value > entry["limit"]:
            correct = False
    return correct, checks
