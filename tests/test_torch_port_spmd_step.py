"""The port's data-parallel train step (``parallel/mesh``: 2 gloo ranks on
the CPU, spawned) against the JAX package's SPMD step on a 2-device mesh
(``make_train_step(..., mesh)``), from the same bridged weights on the same
global batches: the tiny recipe of the JAX package's pad-invariance test
(tests/test_pad_masking.py:141-207: BN-Inception on RGB alone, attention
off, 2 segments, verb 7 / noun 9, float32, lr 1e-2), at the 64-px crops of
tests/test_torch_port_train_step.py so that the last BatchNorms see more
than 1 x 1 maps. Two sequences of two steps from the same weights: a
ragged global batch of 3 true rows in 4 (rank 1 holds the pad row) then a
full one, and the same two batches the other way round, so that each kind
of batch is also a first step. No noise on either side (RGB alone has no
Fusion dropout), so the two frameworks can agree.

Tolerance. A first step, before any amplification, at the tiers of
tests/test_torch_port_train_step.py: losses rtol 1e-5, every parameter and
BatchNorm statistic rtol 1e-3 / atol 1e-4. A second step at the spread
that JAX itself shows when only its topology changes: this training is
chaotic at this size (the late BatchNorms normalize 2 x 2 maps of 8
values), and JAX's step on one device against its step on the 2-device
mesh, from the same weights, differs after the second step by up to
3.2e-4 in the loss, rel-RMSE 5.2e-4 in the parameters and 7.0e-3 in the
statistics (the script entry at the end of this file prints them); so
losses rtol 1e-3, parameters rel-RMSE 1e-3, statistics rel-RMSE 1e-2.
A missing gradient or statistic reduction, a loss scaled by the local
instead of the global count (a world-size factor on every gradient), or a
pad row counted lands orders of magnitude outside the first step's tier,
for either kind of batch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.data.loader import pad_batch as jax_pad_batch
from attention_based_tbn_tpu.models.tbn import TBNModel as JaxTBNModel
from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from attention_based_tbn_tpu.parallel.mesh import shard_batch
from attention_based_tbn_tpu.parallel.optim import build_optimizer
from attention_based_tbn_tpu.parallel.train_step import TrainState as JaxTrainState
from attention_based_tbn_tpu.parallel.train_step import make_train_step as jax_make_train_step
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from torch_port_dist import run_ranks
from torch_port_helpers import SMALL, configs, one_torch_thread, port_model  # noqa: F401

OVERRIDES = ["model.attention.enable=false", "data.audio.enable=false", "data.flow.enable=false",
             "model.num_classes={verb: 7, noun: 9}", "train.optim.lr=0.01",
             "data.train_crop_size=64"]
B, N, HW = 4, 2, 64
RAGGED, FULL = (B - 1, 1), (B, 2)  # (true rows of the global batch, seed)
SEQUENCES = {"ragged_first": (RAGGED, FULL), "full_first": (FULL, RAGGED)}
# (step, loss rtol, state check): see the module docstring
FIRST_STEP_TIER = {"rtol": 1e-3, "atol": 1e-4}
SECOND_STEP_REL_RMSE = {"params": 1e-3, "batch_stats": 1e-2}
LOSS_RTOL = (1e-5, 1e-3)


def _global_batch(true_rows, seed):
    rng = np.random.default_rng(seed)
    batch = {"RGB": rng.integers(0, 255, (true_rows, N, HW, HW, 3)).astype(np.uint8)}
    targets = {"class": {"verb": rng.integers(0, 7, true_rows).astype(np.int32),
                         "noun": rng.integers(0, 9, true_rows).astype(np.int32)}}
    return jax_pad_batch(batch, targets, B)  # the loader's tail padding


def _setup():
    cfg, jcfg = configs(OVERRIDES)
    assert get_modality(cfg) == ["RGB"]
    model = port_model(cfg)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    data = {name: [(*_global_batch(tb, seed), tb) for tb, seed in steps]
            for name, steps in SEQUENCES.items()}
    return jcfg, initial, data


def _jax_runs(jcfg, initial, data, devices):
    """JAX's train step over each sequence from ``initial``: on a mesh of
    ``devices`` (2), or without one (1); per sequence the losses and the
    state after each step."""
    jmodel = JaxTBNModel(JaxTBNSpec.from_config(jcfg, ["RGB"]))
    tx, _ = build_optimizer(jcfg, state_dict_to_jax(initial)["params"], ["RGB"])
    mesh = jax_make_mesh(devices=jax.devices()[:devices]) if devices > 1 else None
    jstep = jax_make_train_step(jmodel, tx, jcfg, mesh)
    place = (lambda tree: shard_batch(tree, mesh)) if mesh is not None else (lambda tree: tree)
    out = {}
    for name, sequence in data.items():
        # fresh arrays per sequence: the step donates its state
        variables = jax.tree.map(jnp.asarray, state_dict_to_jax(initial))
        jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]))
        losses, states = [], []
        for batch, targets, tb in sequence:
            jstate, loss, _ = jstep(jstate, place(jax.tree.map(jnp.asarray, batch)),
                                    place(jax.tree.map(jnp.asarray, targets)),
                                    jax.random.key(0), jnp.asarray(0),
                                    jnp.asarray(tb, jnp.int32))
            losses.append({k: float(v) for k, v in loss.items()})
            states.append({"params": jax.tree.map(np.asarray, jstate.params),
                           "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
        out[name] = dict(jax_losses=losses, jax_states=states)
    return out


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    jcfg, initial, data = _setup()
    ranks = run_ranks("train_sequences", 2, SMALL + OVERRIDES, initial, list(data.values()))
    out = _jax_runs(jcfg, initial, data, 2)
    for index, name in enumerate(data):
        out[name]["ranks"] = [r[index] for r in ranks]
    out["initial"] = state_dict_to_jax(initial)
    return out


@pytest.mark.parametrize("sequence", list(SEQUENCES))
def test_ranks_hold_one_state(runs, sequence):
    """Every rank ends bit-equal: one update from summed gradients, one set
    of global BatchNorm statistics, one generator."""
    first, second = runs[sequence]["ranks"]
    assert first["world"] == second["world"] == 2
    for mine, theirs in zip(first["states"], second["states"]):
        assert set(mine) == set(theirs)
        for key, value in mine.items():
            assert torch.equal(value, theirs[key]), key
    assert torch.equal(first["generator"], second["generator"])
    assert first["losses"] == second["losses"]


@pytest.mark.parametrize("sequence", list(SEQUENCES))
@pytest.mark.parametrize("step", [0, 1])
def test_losses_match_jax_mesh(runs, step, sequence):
    got, want = runs[sequence]["ranks"][0]["losses"][step], runs[sequence]["jax_losses"][step]
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL[step], err_msg=key)


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("sequence", list(SEQUENCES))
@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_state_matches_jax_mesh(runs, collection, step, sequence):
    """After each step of each sequence: see the module docstring."""
    run = runs[sequence]
    got = _leaves(state_dict_to_jax(run["ranks"][0]["states"][step])[collection])
    want = _leaves(run["jax_states"][step][collection])
    before = _leaves((runs["initial"] if step == 0 else run["jax_states"][0])[collection])
    assert set(got) == set(want)
    moved = sum(not np.array_equal(w, before[key]) for key, w in want.items())
    assert moved > 50  # the step did move the state
    if step == 0:
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, err_msg=key, **FIRST_STEP_TIER)
        return
    assert _rel_rmse(got, want) < SECOND_STEP_REL_RMSE[collection]


def _rel_rmse(got, want):
    num = sum(float(np.square(got[k].astype(np.float64) - w).sum()) for k, w in want.items())
    den = sum(float(np.square(w.astype(np.float64)).sum()) for w in want.values())
    return float(np.sqrt(num / den))


if __name__ == "__main__":
    # JAX's own spread between its step on one device and on the 2-device
    # mesh, from the same weights, the tiers of the second steps above:
    #   XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \
    #     PYTHONPATH=. python tests/test_torch_port_spmd_step.py
    jcfg, initial, data = _setup()
    one, two = (_jax_runs(jcfg, initial, data, d) for d in (1, 2))
    for name in data:
        for step in range(len(data[name])):
            a, b = one[name], two[name]
            loss = abs(a["jax_losses"][step]["total"] / b["jax_losses"][step]["total"] - 1)
            gaps = {c: _rel_rmse(_leaves(a["jax_states"][step][c]),
                                 _leaves(b["jax_states"][step][c]))
                    for c in ("params", "batch_stats")}
            print(f"{name} step {step + 1}: loss rel {loss:.3g}, rel-RMSE {gaps}")
