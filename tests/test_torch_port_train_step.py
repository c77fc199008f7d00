"""The port's whole train step against the JAX package's ``make_train_step``
(no mesh) from the same bridged weights on the same batches: RGB + Audio,
MHA attention, 64-px crops, 2 segments, 1.279 s audio, float32, dropout 0
(noise streams of the two frameworks cannot match), the default recipe
otherwise (SGD momentum 0.9, lr 1e-2, grad clip 20, partialbn). A batch
with one pad row takes the masked program, then two full batches the
unmasked one.

Tolerance, the two tiers of the JAX package's own training-parity test
(tests/test_whole_model_parity.py:414-630): this training is chaotic (a
1e-6 change of one stem weight moves the step-3 loss by ~4e-4 relative
there), and the late BatchNorms of random towers on 2x2 maps have
gradients of ~1e-5 with ~1% noise even between two exact JAX lowerings of
the same math. So: losses rtol 1e-5 at every step; the whole state after
ONE step, before any amplification, at rtol 1e-3 / atol 1e-4; after the
third step parameters at rtol 5e-3 / atol 5e-4 and BatchNorm statistics at
rtol 1e-2 / atol 2e-3. A semantic fault (momentum, clip order, freeze
mask, BN momentum or pad-row mask) lands orders of magnitude outside.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.models.tbn import TBNModel as JaxTBNModel
from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu.parallel.optim import build_optimizer
from attention_based_tbn_tpu.parallel.train_step import TrainState as JaxTrainState
from attention_based_tbn_tpu.parallel.train_step import make_train_step as jax_make_train_step
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.parallel.train_step import create_train_state, make_train_step
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from torch_port_helpers import configs, make_batch, one_torch_thread, port_model  # noqa: F401

OVERRIDES = [
    "data.flow.enable=false", "model.attention.attn_dropout=0", "model.fusion_dropout=0",
    "data.train_crop_size=64",
]
B = 3
# (true batch size, seed) per step: one batch with a pad row (the masked
# program, first so that the tight tier holds it), then two full batches
STEPS = ((B - 1, 1), (B, 2), (B, 3))


def _targets(seed):
    rng = np.random.default_rng(100 + seed)
    return {"class": {"verb": rng.integers(0, 125, B).astype(np.int32),
                      "noun": rng.integers(0, 352, B).astype(np.int32)}}


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    cfg, jcfg = configs(OVERRIDES)
    model = port_model(cfg)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    data = [(make_batch(cfg, b=B, seed=seed), _targets(seed), tb) for tb, seed in STEPS]

    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    port_losses, port_states = [], []
    for batch, targets, tb in data:
        state, loss, _ = step(state, batch, targets, 0, tb)
        port_losses.append({k: float(v) for k, v in loss.items()})
        # copies: the next step updates the model's tensors in place
        port_states.append(state_dict_to_jax({k: v.clone() for k, v in model.state_dict().items()}))

    spec = JaxTBNSpec.from_config(jcfg, get_modality(jcfg))
    jmodel = JaxTBNModel(spec)
    variables = jax.tree.map(jnp.asarray, state_dict_to_jax(initial))
    tx, _ = build_optimizer(jcfg, variables["params"], get_modality(jcfg))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    jstep = jax_make_train_step(jmodel, tx, jcfg)
    jax_losses, jax_states = [], []
    for batch, targets, tb in data:
        jstate, loss, _ = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                                jax.tree.map(jnp.asarray, targets), jax.random.key(0),
                                jnp.asarray(0), tb)
        jax_losses.append({k: float(v) for k, v in loss.items()})
        jax_states.append({"params": jax.tree.map(np.asarray, jstate.params),
                           "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    return dict(port_losses=port_losses, jax_losses=jax_losses, port_states=port_states,
                jax_states=jax_states, initial=state_dict_to_jax(initial))


@pytest.mark.parametrize("step", range(len(STEPS)))
def test_losses_match(runs, step):
    got, want = runs["port_losses"][step], runs["jax_losses"][step]
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# (after step, collection, rtol, atol): see the module docstring
TIERS = [(0, "params", 1e-3, 1e-4), (0, "batch_stats", 1e-3, 1e-4),
         (2, "params", 5e-3, 5e-4), (2, "batch_stats", 1e-2, 2e-3)]


@pytest.mark.parametrize("after,collection,rtol,atol", TIERS)
def test_state_matches(runs, after, collection, rtol, atol):
    got = _leaves(runs["port_states"][after][collection])
    want = _leaves(runs["jax_states"][after][collection])
    start = _leaves(runs["initial"][collection])
    assert set(got) == set(want)
    moved = 0
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=rtol, atol=atol, err_msg=key)
        moved += not np.array_equal(w, start[key])
    assert moved > 100  # the steps did move the state
