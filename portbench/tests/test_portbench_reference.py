"""The plain reference against the program's CPU path at a small size in
float32: the same state-dict layout, the same eval outputs, the same
trainable leaves and, through a train step, the same losses and gradient
norms."""

from __future__ import annotations

import torch
import pytest

from portbench.harness import checks, seeded
from portbench.harness.catalog import Catalog
from portbench.reference import tbn, train as ref_train
from portbench.tests import tiny

CELLS = ("flagship.serve_b10_closed2", "resnet101.serve_b10_closed2")


@pytest.mark.parametrize("config", ["tbn_bninception_mha", "tbn_resnet101"])
def test_layout_equals_the_program_state_dict(config):
    from attention_based_tbn_tpu_torch.models.tbn import TBNModel, TBNSpec

    catalog = Catalog()
    run_config = catalog.config(config)
    cfg = tiny.Run.port_config(type("R", (), {"config": run_config})(), ())
    with torch.device("meta"):
        model = TBNModel(TBNSpec.from_config(cfg, run_config["model"]["modality"]))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: shape for k, (shape, _, _) in tbn.param_spec(run_config["model"]).items()}
    assert got == want


def _program(run):
    from attention_based_tbn_tpu_torch.models.builder import build_model

    cfg = run.port_config([f"train.num_segments=2", "test.num_segments=2"])
    params = seeded.make_params(run.desc, run.seed, "cpu")
    model = build_model(cfg, list(run.desc["modality"]), "cpu")
    model.load_state_dict(params, strict=True)
    return cfg, model, params


@pytest.mark.parametrize("cell", CELLS)
def test_eval_outputs_agree(cell):
    run = tiny.small_run(cell)
    _, model, params = _program(run)
    batch = seeded.clips(run.desc, 2, 2, seeded.generator(run.seed, "inputs", "cpu"), "cpu")
    with torch.no_grad():
        got = model(batch)
    want = tbn.forward_in_blocks(params, run.desc, batch, rows=2)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape
        # float32 on both sides: summation order alone
        assert (got[key].float() - want[key]).abs().max() <= 1e-5 * want[key].abs().max()


def test_a_train_step_agrees():
    from attention_based_tbn_tpu_torch.parallel.train_step import (create_train_state,
                                                                   make_train_step)

    run = tiny.small_run("flagship.train_b48")
    cfg, model, params = _program(run)
    gen = seeded.generator(run.seed, "inputs", "cpu")
    batch, labels = seeded.clips(run.desc, 2, 2, gen, "cpu"), seeded.labels(run.desc, 2, gen, "cpu")
    state = create_train_state(cfg, model, seed=5)
    trainer = ref_train.Trainer(params, run.desc, run.config["train"],
                                torch.Generator().manual_seed(5))
    frozen = set(state.optimizer.frozen_names)
    assert set(trainer.names) == {n for n, _ in model.named_parameters()} - frozen
    _, loss, preds = make_train_step(cfg)(state, batch, {"class": labels}, 0, 2)
    want, logits = trainer.step(batch, labels)
    # the same weights, batch and dropout masks: one float32 forward apart
    assert abs(float(loss["total"]) - want["total"]) <= 1e-5 * want["total"]
    momentum = state.optimizer.inner.state
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {k: float(v.norm()) for k, v in trainer.first_grads.items()}
    change = dict(grads, **{"statistic.running_var": 1.0})  # the gradients alone here
    port = {"losses": [float(loss["total"])], "logits": [{k: preds[k] for k in logits}],
            "grad_norms": {names[id(p)]: float(momentum[p]["momentum_buffer"].norm())
                           for p in state.optimizer.trainable},
            "head_grads": {names[id(p)]: momentum[p]["momentum_buffer"].detach().clone()
                           for p in state.optimizer.trainable
                           if names[id(p)].startswith(("fusion.", "classifier."))},
            "change_norms": change}
    ref = {"losses": [want["total"]], "logits": [logits], "grad_norms": grads,
           "head_grads": {k: v for k, v in trainer.first_grads.items()
                          if k.startswith(("fusion.", "classifier."))},
           "change_norms": change}
    numbers = checks.train_numbers(port, ref)[0]
    assert numbers["logits_rel_rmse"] <= 1e-4  # float32 orders through ~70 layers
    # float32 on both sides, but BatchNorm's statistics over a handful of
    # values at this size amplify summation order in the backward: a few
    # thousandths (the reference alone moves as much between float32 and
    # float64 here); a wrong layer reads tens of percent
    assert numbers["grad_norm_gap_worst"] <= 1e-2
    # Fusion's and the heads' whole gradients sit after the towers: the same
    # few ten-thousandths as the logits' inputs
    assert numbers["head_grad_rel_rmse"] <= 2e-3
