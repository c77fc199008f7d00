"""The port's training loop on the CPU: ``train_one_epoch`` and
``validate`` over a tiny in-memory loader with the JAX loader's
``(batch, targets, meta)`` contract (full batches, a ragged last batch, and
a batch padded past its true size), and the ``Metric`` accounting against
the JAX package's on seeded logits (exact: counts and float32 sums of the
same numbers)."""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from attention_based_tbn_tpu.utils.metrics import Metric as JaxMetric
from attention_based_tbn_tpu.utils.misc import get_time_diff as jax_get_time_diff
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.parallel.train_step import (
    create_train_state, make_eval_step, make_infer_step, make_train_step,
)
from attention_based_tbn_tpu_torch.tools.train import train_one_epoch, validate
from attention_based_tbn_tpu_torch.utils.metrics import Metric
from attention_based_tbn_tpu_torch.utils.misc import get_modality, get_time_diff
from torch_port_helpers import configs, make_batch, one_torch_thread  # noqa: F401


class MemoryLoader:
    """Seeded batches of ``sizes[i]`` clips; a (rows, true) pair pads the
    batch to ``rows`` with copies of its first clip, as the JAX loader pads
    to the mesh size."""

    def __init__(self, cfg, sizes, seed=0):
        self.cfg, self.sizes, self.seed, self.epochs = cfg, sizes, seed, []

    def __len__(self):
        return len(self.sizes)

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        for i, size in enumerate(self.sizes):
            rows, true = size if isinstance(size, tuple) else (size, size)
            batch = make_batch(self.cfg, b=true, seed=self.seed + i)
            rng = np.random.default_rng(self.seed + i)
            targets = {"class": {"verb": rng.integers(0, 125, true).astype(np.int32),
                                 "noun": rng.integers(0, 352, true).astype(np.int32)}}
            pad = lambda x: np.concatenate([x, np.repeat(x[:1], rows - true, 0)])  # noqa: E731
            batch = {k: pad(v) for k, v in batch.items()}
            targets = {"class": {k: pad(v) for k, v in targets["class"].items()}}
            yield batch, targets, {"batch_size": true}


@pytest.fixture(scope="module")
def trained():
    torch.set_num_threads(1)
    cfg, _ = configs(["data.flow.enable=false", "data.train_crop_size=64"])
    model = build_model(cfg, get_modality(cfg), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(cfg, model)
    seen = []
    step = make_train_step(cfg)

    def recording_step(state, batch, targets, epoch, bs):
        forward = state.model.forward
        state.model.forward = lambda b, true_batch=None, generator=None: (
            seen.append(true_batch) or forward(b, true_batch, generator))
        try:
            return step(state, batch, targets, epoch, bs)
        finally:
            del state.model.forward

    loader = MemoryLoader(cfg, [2, 2, (3, 2), 1])
    metric = Metric(cfg, len(loader))
    state, train_loss = train_one_epoch(cfg, state, recording_step, loader, metric, 3,
                                        logging.getLogger("test"))
    val = validate(cfg, state, make_eval_step(cfg), MemoryLoader(cfg, [2, (2, 1)], seed=9), 3,
                   logging.getLogger("test"))
    return cfg, model, state, before, train_loss, val, seen, loader


def test_epoch_runs_every_batch(trained):
    cfg, model, state, before, train_loss, _, seen, loader = trained
    assert state.step == 4 and loader.epochs == [3]
    # full batches take no mask; the padded one masks its pad row; the
    # ragged last batch (1 clip, unpadded) takes no mask at its own shape
    assert seen == [None, None, 2, None]
    assert set(train_loss) == {"verb", "noun", "all_class", "total"}
    assert all(np.isfinite(v) for v in train_loss.values())


def test_epoch_updates_weights_and_statistics(trained):
    _, model, _, before, *_ = trained
    after = model.state_dict()
    assert not torch.equal(after["Base_RGB.inception_3a_1x1.weight"],
                           before["Base_RGB.inception_3a_1x1.weight"])
    assert not torch.equal(after["Base_Audio.conv1_7x7_s2_bn.weight"],
                           before["Base_Audio.conv1_7x7_s2_bn.weight"])
    for tower in ("Base_RGB", "Base_Audio"):
        assert not torch.equal(after[f"{tower}.inception_5b_1x1_bn.running_mean"],
                               before[f"{tower}.inception_5b_1x1_bn.running_mean"])
        # partialbn: frozen affine parameters stay bit-identical
        for leaf in ("weight", "bias"):
            key = f"{tower}.inception_4e_3x3_bn.{leaf}"
            assert torch.equal(after[key], before[key])


def test_validate_reports_losses_and_accuracy(trained):
    _, model, state, *_rest = trained
    loss, accuracy, conf = trained[5]
    assert not model.training
    assert set(accuracy) == {"verb", "noun", "all_class"}
    assert all(len(v) == 2 and 0.0 <= min(v) and max(v) <= 100.0 for v in accuracy.values())
    assert conf["verb"].shape == (125, 125) and conf["verb"].sum() == 3  # 2 + 1 true clips
    assert np.isfinite(loss["total"])
    preds = make_infer_step()(state, make_batch(trained[0], b=2))
    assert preds["verb"].shape == (2, 125) and preds["weights"].shape == (4, 1, 8)


def test_get_time_diff_matches_jax():
    for start, end in ((0.0, 3725.9), (10.0, 70.0), (5.5, 5.6)):
        assert get_time_diff(start, end) == jax_get_time_diff(start, end)


def test_metric_matches_jax():
    cfg, jcfg = configs(["model.attention.use_entropy=true"])
    rng = np.random.default_rng(0)
    port, jax_metric = Metric(cfg, 3), JaxMetric(jcfg, 3)
    for rows, true in ((8, 8), (8, 5), (6, 6)):
        preds = {"verb": rng.standard_normal((rows, 125)).astype(np.float32),
                 "noun": rng.standard_normal((rows, 352)).astype(np.float32)}
        labels = {"verb": rng.integers(0, 125, rows).astype(np.int32),
                  "noun": rng.integers(0, 352, rows).astype(np.int32)}
        # make some top-1 and top-5 hits
        labels["verb"][:3] = preds["verb"][:3].argmax(-1)
        labels["noun"][:4] = np.argsort(preds["noun"][:4], -1)[:, -3]
        loss = {k: np.float32(rng.random()) for k in ("verb", "noun", "all_class", "entropy",
                                                      "total")}
        port.update({k: torch.from_numpy(v) for k, v in preds.items()}, {"class": labels},
                    {k: torch.tensor(v) for k, v in loss.items()}, batch_size=true)
        jax_metric.update({k: jnp.asarray(v) for k, v in preds.items()}, {"class": labels},
                          {k: jnp.asarray(v) for k, v in loss.items()}, batch_size=true)
    got, want = port.compute(), jax_metric.compute()
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    assert got[1] == want[1]
    assert got[1]["verb"][0] > 0 and got[1]["noun"][1] > 0
    for key in want[2]:
        np.testing.assert_array_equal(got[2][key], want[2][key])
