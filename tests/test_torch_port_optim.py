"""The port's optimizer against the JAX package's ``parallel/optim.py``,
with no model compile: the freeze labels of every parameter for ``all``,
``partialbn`` (7x7 and two-branch audio stems) and no freezing, carried to
the JAX tree by the weight bridge; K updates from the same seeded
gradients through the port's ``Optimizer`` and ``build_optimizer``'s optax
chain (SGD and Adam, weight decay, the global-norm clip active and not, an
LR change, ``accumulator_step=2``); and ``lr_at_epoch``.

Tolerance rtol 1e-5 / atol 1e-7 on the parameters after the updates (the
global norm sums ~27M squares in another order; everything else is the
same float32 arithmetic)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from attention_based_tbn_tpu.parallel.optim import (
    _freeze_labels, build_optimizer, lr_at_epoch as jax_lr_at_epoch, set_learning_rate,
)
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.parallel.optim import Optimizer, freeze_labels, lr_at_epoch
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from torch_port_helpers import configs, one_torch_thread  # noqa: F401 (autouse fixture)

BASE = ["data.flow.enable=false"]


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("overrides", [
    ["model.freeze_mode=partialbn"],
    ["model.freeze_mode=partialbn", "model.bninception.audio_stem=true"],
    ["model.freeze_mode=all"],
    ["model.freeze_base=false"],
])
def test_freeze_labels_match_jax(overrides):
    cfg, jcfg = configs(BASE + overrides)
    model = build_model(cfg, get_modality(cfg), device="cpu")
    labels = freeze_labels(model, cfg)
    marks = {n: np.full(p.shape, labels[n] == "train", np.float32)
             for n, p in model.named_parameters()}
    params = state_dict_to_jax(marks)["params"]
    want = _leaves(_freeze_labels(params, jcfg, get_modality(jcfg)))
    got = _leaves(params)
    assert set(got) == set(want)
    for key, label in want.items():
        assert np.all(got[key] == (label == "train")), key
    frozen = {n for n, label in labels.items() if label == "freeze"}
    if "model.freeze_base=false" in overrides:
        assert not frozen
    elif "model.freeze_mode=partialbn" in overrides:
        assert "Base_RGB.inception_3a_1x1_bn.weight" in frozen
        assert "Base_RGB.conv1_7x7_s2_bn.weight" not in frozen
        assert all(n.endswith(("_bn.weight", "_bn.bias")) for n in frozen)


OPTIM_CASES = {
    "sgd": ["train.optim.weight_decay=1e-4"],
    "adam": ["train.optim.type=adam", "train.optim.lr=1e-3", "train.optim.weight_decay=1e-4"],
    "sgd_accumulate": ["train.optim.weight_decay=1e-4", "train.optim.accumulator_step=2"],
}
# per micro-step: (gradient scale, learning rate set before it); the global
# gradient norm is ~5e3 * scale over these ~27M parameters, so the clip at
# 20 fires at scale 1 and not at 1e-3
SCHEDULE = [(1.0, None), (1e-3, None), (1.0, 3e-3), (1.0, None)]


@pytest.mark.parametrize("case", sorted(OPTIM_CASES))
def test_updates_match_optax(case):
    cfg, jcfg = configs(BASE + OPTIM_CASES[case])
    model = build_model(cfg, get_modality(cfg), device="cpu")
    initial = state_dict_to_jax({k: v.clone() for k, v in model.state_dict().items()})
    opt = Optimizer(cfg, model)
    params = jax.tree.map(jnp.asarray, initial["params"])
    tx, _ = build_optimizer(jcfg, params, get_modality(jcfg))
    opt_state = tx.init(params)
    update = jax.jit(tx.update)

    named = dict(model.named_parameters())
    rng = np.random.default_rng(0)
    applied = []
    for scale, lr in SCHEDULE:
        grads = {n: (rng.standard_normal(p.shape) * scale * 1e-3).astype(np.float32)
                 for n, p in named.items()}
        if lr is not None:
            opt.set_learning_rate(lr)
            opt_state = set_learning_rate(opt_state, lr)
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n])
        applied.append(opt.step())
        jgrads = jax.tree.map(jnp.asarray, state_dict_to_jax(grads)["params"])
        updates, opt_state = update(jgrads, opt_state, params)
        params = optax.apply_updates(params, updates)
    assert applied == ([False, True] * 2 if case == "sgd_accumulate" else [True] * 4)
    assert opt.current_learning_rate() == 3e-3
    assert all(p.grad is None for p in named.values())

    got = _leaves(state_dict_to_jax(model.state_dict())["params"])
    want = _leaves(params)
    start = _leaves(initial["params"])
    changed = 0
    for key, w in want.items():
        np.testing.assert_allclose(got[key], np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=key)
        changed += not np.array_equal(np.asarray(w), start[key])
    frozen = {k for k in start if "/bn/" in k and "conv1_7x7_s2" not in k}
    assert all(np.array_equal(got[k], start[k]) for k in frozen)  # partialbn
    assert changed == len(want) - len(frozen)


@pytest.mark.parametrize("overrides", [
    [], ["train.warmup.enable=true"],
    ["train.warmup.enable=true", "train.warmup.multiplier=4", "train.warmup.epochs=3"],
    ["train.scheduler.lr_steps=[3,7]", "train.scheduler.lr_decay=0.5"],
    ["train.optim.type=adam"],
])
def test_lr_at_epoch_matches_jax(overrides):
    cfg, jcfg = configs(overrides)
    for epoch in range(30):
        assert lr_at_epoch(cfg, epoch) == pytest.approx(jax_lr_at_epoch(jcfg, epoch), rel=1e-12)


def test_lr_schedule_values():
    cfg, _ = configs([])
    assert lr_at_epoch(cfg, 0) == pytest.approx(1e-2)
    assert lr_at_epoch(cfg, 20) == pytest.approx(1e-3)
    cfg, _ = configs(["train.warmup.enable=true"])
    assert lr_at_epoch(cfg, 0) == 0.0 and lr_at_epoch(cfg, 5) == pytest.approx(1e-2)
