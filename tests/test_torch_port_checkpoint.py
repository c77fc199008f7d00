"""The port's training checkpoints (utils/checkpoint.py): a save / restore
round trip of the model, the optimizer (momentum and a partial gradient
accumulation), the dropout generator, the step and the history, after
which the restored state steps bit for bit as the saved one; the history
sidecar against the JAX package's; a save that fails mid-write leaves the
previous checkpoint whole (as tests/test_checkpoint.py::
test_preemption_mid_save_keeps_previous holds the JAX package's); and
evaluation's ``load_eval_weights`` takes a training checkpoint.

RGB + Audio, 64-px crops, 2 segments, float32, the default dropout (so the
generator's state matters), ``accumulator_step=2``."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from attention_based_tbn_tpu.utils import checkpoint as jax_checkpoint
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.parallel.train_step import create_train_state, make_train_step
from attention_based_tbn_tpu_torch.utils import checkpoint
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from torch_port_helpers import configs, make_batch, one_torch_thread  # noqa: F401

OVERRIDES = ["data.flow.enable=false", "data.train_crop_size=64",
             "train.optim.accumulator_step=2"]
B = 2
HISTORY = dict(
    train_loss_hist=[{"verb": 4.8, "noun": 5.9, "all_class": 10.7, "total": 10.7}],
    val_loss_hist=[{"verb": 4.7, "noun": 5.8, "all_class": 10.5, "total": 10.5}],
    val_acc_hist={"verb": [[50.0, 100.0]], "noun": [[0.0, 50.0]], "all_class": [[0.0, 50.0]]},
    conf_mat={"verb": np.eye(3), "noun": np.arange(4.0).reshape(2, 2)},
)


def _data(cfg, seed):
    rng = np.random.default_rng(100 + seed)
    targets = {"class": {"verb": rng.integers(0, 125, B).astype(np.int32),
                         "noun": rng.integers(0, 352, B).astype(np.int32)}}
    return make_batch(cfg, b=B, seed=seed), targets


def _state(cfg, seed):
    return create_train_state(cfg, build_model(cfg, get_modality(cfg), device="cpu", seed=seed))


def _snapshot(state):
    opt = state.optimizer
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "momentum": [opt.inner.state[p]["momentum_buffer"].clone()
                         for p in opt.trainable if p in opt.inner.state],
            "acc": [a.clone() for a in opt._acc], "micro": opt._micro,
            "generator": state.generator.get_state().clone(), "step": state.step}


def _assert_same(got, want):
    assert got["step"] == want["step"] and got["micro"] == want["micro"]
    assert torch.equal(got["generator"], want["generator"])
    assert set(got["model"]) == set(want["model"])
    for key, value in want["model"].items():
        assert torch.equal(got["model"][key], value), key
    for name in ("momentum", "acc"):
        assert len(got[name]) == len(want[name])
        assert all(torch.equal(a, b) for a, b in zip(got[name], want[name])), name


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Three micro-steps (one update, then one half of the next), a save,
    then one more step: the snapshot at the save and after that step."""
    torch.set_num_threads(1)
    cfg, _ = configs(OVERRIDES)
    state = _state(cfg, seed=0)
    step = make_train_step(cfg)
    for seed in (1, 2, 3):
        state, _, _ = step(state, *_data(cfg, seed), 0, B)
    at_save = _snapshot(state)
    stem = str(tmp_path_factory.mktemp("port_checkpoint") / "run" / "tbn")
    path = checkpoint.save_checkpoint(stem, state, 4, **HISTORY)
    state, _, _ = step(state, *_data(cfg, 4), 0, B)
    return cfg, stem, path, at_save, _snapshot(state)


def test_round_trip_steps_as_the_saved_state(saved):
    cfg, stem, path, at_save, after = saved
    assert path == stem + ".pth" and os.path.isfile(path)
    assert at_save["micro"] == 1 and at_save["acc"] and at_save["momentum"]
    state = _state(cfg, seed=7)  # other weights and noise
    state, history = checkpoint.restore_checkpoint(path, state)
    _assert_same(_snapshot(state), at_save)
    assert history == {"epoch": 4, "train_loss": HISTORY["train_loss_hist"],
                       "validation_loss": HISTORY["val_loss_hist"],
                       "validation_accuracy": HISTORY["val_acc_hist"]}
    state, _, _ = make_train_step(cfg)(state, *_data(cfg, 4), 0, B)
    _assert_same(_snapshot(state), after)


def test_file_holds_the_reference_dict(saved):
    _, _, path, at_save, _ = saved
    data = torch.load(path, map_location="cpu", weights_only=True)
    assert set(data) == {"epoch", "model", "optimizer", "train_loss", "validation_loss",
                         "validation_accuracy", "conf_mat", "generator", "step"}
    assert data["epoch"] == 4 and data["step"] == at_save["step"]
    assert "Base_RGB.conv1_7x7_s2.weight" in data["model"]
    np.testing.assert_array_equal(data["conf_mat"]["noun"].numpy(), HISTORY["conf_mat"]["noun"])


def test_history_sidecar_matches_jax(saved, tmp_path):
    _, stem, _, _, _ = saved
    jax_path = str(tmp_path / "jax_ckpt")
    jax_checkpoint.save_checkpoint(jax_path, {"w": jnp.zeros(1)}, 4, **HISTORY)
    jax_checkpoint.wait_until_finished()
    with open(jax_path + ".history.json") as fh:
        want = json.load(fh)
    with open(checkpoint.history_path(stem)) as fh:
        assert json.load(fh) == want


def test_failed_save_keeps_the_previous_checkpoint(saved, tmp_path, monkeypatch):
    cfg, _, path, at_save, _ = saved
    state = _state(cfg, seed=7)
    checkpoint.restore_checkpoint(path, state)
    stem = str(tmp_path / "tbn")
    checkpoint.save_checkpoint(stem, state, 0)

    def dies_mid_write(obj, handle):
        handle.write(b"partial")
        raise OSError("preempted")

    monkeypatch.setattr(checkpoint.torch, "save", dies_mid_write)
    with pytest.raises(OSError, match="preempted"):
        checkpoint.save_checkpoint(stem, state, 1)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == ["tbn.history.json", "tbn.pth"]
    restored, history = checkpoint.restore_checkpoint(stem + ".pth", _state(cfg, seed=9))
    assert history["epoch"] == 0
    _assert_same(_snapshot(restored), at_save)
    with open(checkpoint.history_path(stem)) as fh:
        assert json.load(fh)["epoch"] == 0


def test_eval_restore_takes_the_training_checkpoint(saved):
    cfg, _, path, at_save, _ = saved
    model = build_model(cfg, get_modality(cfg), device="cpu", seed=7)
    left_out = checkpoint.load_eval_weights(model, path)
    assert left_out == {"not_in_file": [], "not_in_model": []}
    for key, value in at_save["model"].items():
        assert torch.equal(model.state_dict()[key], value), key


def test_restore_refuses_a_foreign_optimizer(saved, tmp_path):
    cfg, _, path, _, _ = saved
    data = torch.load(path, map_location="cpu", weights_only=True)
    data["optimizer"] = {"state": {}, "param_groups": []}  # a torch.optim state dict
    foreign = str(tmp_path / "foreign.pth")
    torch.save(data, foreign)
    with pytest.raises(ValueError, match="not an optimizer state of the port"):
        checkpoint.restore_checkpoint(foreign, _state(cfg, seed=7))


def test_restore_of_a_bare_state_dict_starts_at_epoch_0(saved, tmp_path):
    """A file with weights only (no epoch, optimizer or generator) loads the
    model and gives an empty history: ``run_trainer`` starts at epoch 0,
    as the JAX package does without a history."""
    cfg, _, _, at_save, _ = saved
    path = str(tmp_path / "bare.pth")
    torch.save({"model": at_save["model"]}, path)
    state = _state(cfg, seed=7)
    generator, step = state.generator.get_state().clone(), state.step
    state, history = checkpoint.restore_checkpoint(path, state)
    assert history == {}
    assert torch.equal(state.generator.get_state(), generator) and state.step == step
    for key, value in at_save["model"].items():
        assert torch.equal(state.model.state_dict()[key], value), key
