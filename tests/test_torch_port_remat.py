"""``tpu.remat``: each tower's training forward recomputed in the backward.

float32 on the CPU, the same weights and batch with remat on and off:

* a small BN-Inception TBN (RGB + Flow, fusion dropout 0.5, 64-px crops,
  2 segments, one clip): one train step through
  ``parallel/train_step.make_train_step``; every parameter, momentum buffer
  and running statistic after it equal, and each tower's forward run twice
  (the recompute) while its running statistics took one update;
* a ResNet-18 tower and a VGG-11 tower with dropout 0.5 from an explicit
  generator (``layers.rematerialized``): the gradients of a loss on their
  features and the running statistics equal, and the generator left where
  the plain forward leaves it;
* the port's remat step against the JAX package's remat step (RGB alone,
  dropout 0: the two frameworks' noise streams cannot match) within the
  tiers of tests/test_torch_port_train_step.py: losses rtol 1e-5; the
  state at its amplified tier (parameters rtol 5e-3 / atol 5e-4,
  statistics rtol 1e-2 / atol 2e-3), not the one-step tier: the JAX
  package's remat program rounds apart from its plain one on the CPU (3e-2
  relative at conv1 in tests/test_remat.py), and the port's remat step is
  the plain step bit for bit;
* two gloo ranks (``parallel/mesh``): the remat steps equal the plain
  ones on every rank;
* on a card (``cuda`` marker, skipped here): the BN-Inception tower with
  the pool kernel, deterministic cuDNN: gradients and statistics equal.

JAX is imported inside the fixture that needs it: the card's machine has
no JAX.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from attention_based_tbn_tpu_torch.models import layers
from attention_based_tbn_tpu_torch.models.bn_inception import BNInception
from attention_based_tbn_tpu_torch.models.resnet import ResNet
from attention_based_tbn_tpu_torch.models.vgg import VGG
from attention_based_tbn_tpu_torch.parallel.train_step import create_train_state, make_train_step

B = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _targets(b, seed=0):
    rng = np.random.default_rng(100 + seed)
    return {"class": {"verb": rng.integers(0, 125, b).astype(np.int32),
                      "noun": rng.integers(0, 352, b).astype(np.int32)}}


def _step(cfg, remat: bool, initial, batch, targets):
    """One port train step of a copy of the model ``initial`` with tpu.remat
    set; the state after it, the losses and each tower's forward count."""
    model = copy.deepcopy(initial)
    model.spec = dataclasses.replace(model.spec, remat=remat)
    calls = {}
    for m in model.spec.modality:
        getattr(model, f"Base_{m}").register_forward_pre_hook(
            lambda module, args, m=m: calls.__setitem__(m, calls.get(m, 0) + 1))
    state = create_train_state(cfg, model)
    state, loss, _ = make_train_step(cfg)(state, batch, targets, 0, len(batch["RGB"]))
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    momentum = {k: v["momentum_buffer"].clone()
                for k, v in state.optimizer.inner.state_dict()["state"].items()}
    return after, momentum, {k: float(v) for k, v in loss.items()}, calls, state.generator


@pytest.fixture(scope="module")
def bninception_steps():
    from torch_port_helpers import configs, make_batch, port_model
    cfg, jcfg = configs(["data.audio.enable=false", "data.train_crop_size=64"])
    model = port_model(cfg)
    batch = make_batch(cfg, b=1, seed=1)
    runs = {remat: _step(cfg, remat, model, batch, _targets(1)) for remat in (False, True)}
    return model.state_dict(), runs


def test_bninception_step_equal_with_remat(bninception_steps):
    initial, runs = bninception_steps
    (plain, plain_momentum, plain_loss, _, plain_gen) = runs[False]
    (remat, remat_momentum, remat_loss, _, remat_gen) = runs[True]
    assert plain_loss == remat_loss
    assert plain.keys() == remat.keys()
    changed = 0
    for key, value in plain.items():
        assert torch.equal(remat[key], value), key
        changed += not torch.equal(value, initial[key])
    assert changed > 100  # the step moved the weights and the statistics
    assert plain_momentum.keys() == remat_momentum.keys() and len(plain_momentum) > 100
    for key, value in plain_momentum.items():
        assert torch.equal(remat_momentum[key], value), key
    assert torch.equal(plain_gen.get_state(), remat_gen.get_state())


def test_bninception_statistics_updated_once(bninception_steps):
    """With remat each tower's forward runs twice (the recompute in the
    backward) and its running statistics still take one momentum update:
    they equal the plain step's, which runs the forward once."""
    initial, runs = bninception_steps
    assert runs[False][3] == {"RGB": 1, "Flow": 1}
    assert runs[True][3] == {"RGB": 2, "Flow": 2}
    for key, value in runs[False][0].items():
        if "running_" in key:
            assert not torch.equal(value, initial[key]), key
            assert torch.equal(runs[True][0][key], value), key


def _tower_grads(initial, x, remat: bool, with_generator: bool):
    tower = copy.deepcopy(initial).train()
    gen = torch.Generator().manual_seed(7) if with_generator else None
    args = (x, torch.float32, None) + ((gen,) if with_generator else ())
    calls = []
    tower.register_forward_pre_hook(lambda *a: calls.append(1))
    feature = layers.rematerialized(tower, *args, generator=gen) if remat else tower(*args)
    weights = torch.linspace(-1.0, 1.0, feature.numel()).view_as(feature)
    (feature * weights).sum().backward()
    grads = {n: p.grad.clone() for n, p in tower.named_parameters() if p.grad is not None}
    stats = {n: b.clone() for n, b in tower.named_buffers() if "running_" in n}
    return feature.detach(), grads, stats, len(calls), gen


@pytest.mark.parametrize("arch", ["resnet18", "vgg11_dropout"])
def test_tower_gradients_equal_with_remat(arch):
    """The recompute runs (two forwards) and changes nothing: gradients,
    statistics, and, for VGG's dropout, the masks (the generator is set
    back for the recompute and restored after it)."""
    torch.manual_seed(0)  # torch's default init: VGG's 10^8 parameters draw fast
    if arch == "resnet18":
        tower, with_generator = ResNet(3, 18), False
        tower.reset_parameters(torch.Generator().manual_seed(0))
    else:
        tower, with_generator = VGG(3, "11"), True
    x = torch.randn((2, 3, 32, 32), generator=torch.Generator().manual_seed(3))
    feature, grads, stats, calls, gen = _tower_grads(tower, x, False, with_generator)
    r_feature, r_grads, r_stats, r_calls, r_gen = _tower_grads(tower, x, True, with_generator)
    assert (calls, r_calls) == (1, 2)
    assert torch.equal(feature, r_feature)
    assert grads.keys() == r_grads.keys() and len(grads) > 10
    for name, g in grads.items():
        assert torch.equal(r_grads[name], g), name
    assert stats.keys() == r_stats.keys()
    for name, s in stats.items():
        assert torch.equal(r_stats[name], s), name
    if with_generator:
        assert (feature == 0).any()  # dropout dropped
        assert torch.equal(gen.get_state(), r_gen.get_state())


def test_remat_key_reaches_the_spec():
    from torch_port_helpers import configs
    from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
    from attention_based_tbn_tpu_torch.models.tbn import TBNSpec
    for value in (True, False):
        cfg, jcfg = configs([f"tpu.remat={str(value).lower()}"])
        assert TBNSpec.from_config(cfg, ("RGB",)).remat is value
        assert JaxTBNSpec.from_config(jcfg, ("RGB",)).remat is value


def test_eval_ignores_remat():
    """Without a backward there is nothing to recompute: the eval forward
    runs each tower once."""
    calls = []
    from torch_port_helpers import configs, make_batch, port_model
    cfg, _ = configs(["data.flow.enable=false", "data.audio.enable=false", "tpu.remat=true",
                      "model.attention.enable=false"])
    model = port_model(cfg)
    assert model.spec.remat
    model.Base_RGB.register_forward_pre_hook(lambda *a: calls.append(1))
    with torch.no_grad():
        model.eval()({k: torch.as_tensor(v) for k, v in make_batch(cfg, b=1).items()})
    assert len(calls) == 1


def test_remat_on_two_ranks_equals_the_plain_step():
    """Two gloo ranks (``parallel/mesh``), one ragged global batch (3 true
    rows of 4, 32-px crops): every rank's remat step equals its plain one
    bit for bit. The recompute normalizes with the global statistics
    again, so its BatchNorm all-reduces run on both ranks alike; a rank
    that skipped one would hang the other or move its gradients."""
    from torch_port_dist import run_ranks
    from torch_port_helpers import SMALL, configs, port_model
    over = ["model.attention.enable=false", "data.audio.enable=false", "data.flow.enable=false",
            "data.train_crop_size=32"]
    cfg, _ = configs(over)
    initial = {k: v.detach().clone() for k, v in port_model(cfg).state_dict().items()}
    rng = np.random.default_rng(4)
    steps = [({"RGB": rng.integers(0, 255, (4, 2, 32, 32, 3)).astype(np.uint8)},
              _targets(4, 5), 3)]
    runs = {remat: run_ranks("train_steps", 2, SMALL + over + [f"tpu.remat={str(remat).lower()}"],
                             initial, steps) for remat in (False, True)}
    for plain, remat in zip(runs[False], runs[True]):
        assert plain["world"] == remat["world"] == 2
        assert plain["losses"] == remat["losses"]
        for mine, theirs in zip(plain["states"], remat["states"]):
            assert mine.keys() == theirs.keys()
            for key, value in mine.items():
                assert torch.equal(theirs[key], value), key
    assert not torch.equal(runs[True][0]["states"][0]["Base_RGB.conv2_3x3_bn.running_mean"],
                           initial["Base_RGB.conv2_3x3_bn.running_mean"])


@pytest.fixture(scope="module")
def jax_remat_step():
    """The port's and the JAX package's remat train step from the same
    bridged weights on one batch (RGB alone, attention off, dropout 0)."""
    import jax
    import jax.numpy as jnp
    from torch_port_helpers import configs, make_batch, port_model
    from attention_based_tbn_tpu.models.tbn import TBNModel as JaxTBNModel
    from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
    from attention_based_tbn_tpu.parallel.optim import build_optimizer
    from attention_based_tbn_tpu.parallel.train_step import TrainState as JaxTrainState
    from attention_based_tbn_tpu.parallel.train_step import make_train_step as jax_make_step
    from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
    from attention_based_tbn_tpu_torch.utils.misc import get_modality

    cfg, jcfg = configs(["data.flow.enable=false", "data.audio.enable=false",
                         "model.attention.enable=false", "model.fusion_dropout=0",
                         "data.train_crop_size=64", "tpu.remat=true"])
    model = port_model(cfg)
    initial = state_dict_to_jax({k: v.clone() for k, v in model.state_dict().items()})
    batch, targets = make_batch(cfg, b=B, seed=2), _targets(B, 2)
    assert model.spec.remat
    state = create_train_state(cfg, model)
    _, loss, _ = make_train_step(cfg)(state, batch, targets, 0, B)
    port = (state_dict_to_jax(model.state_dict()), {k: float(v) for k, v in loss.items()})

    spec = JaxTBNSpec.from_config(jcfg, get_modality(jcfg))
    assert spec.remat
    variables = jax.tree.map(jnp.asarray, initial)
    tx, _ = build_optimizer(jcfg, variables["params"], get_modality(jcfg))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    jstep = jax_make_step(JaxTBNModel(spec), tx, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jtargets = jax.tree.map(jnp.asarray, targets)
    jstate, jloss, _ = jstep(jstate, jbatch, jtargets, jax.random.key(0), jnp.asarray(0), B)
    want = {"params": jax.tree.map(np.asarray, jstate.params),
            "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}
    return port, (want, {k: float(v) for k, v in jloss.items()})


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def test_remat_step_matches_jax_remat_step(jax_remat_step):
    (port_state, port_loss), (jax_state, jax_loss) = jax_remat_step
    for key, value in jax_loss.items():
        if key in port_loss:
            np.testing.assert_allclose(port_loss[key], value, rtol=1e-5, err_msg=key)
    for collection, rtol, atol in (("params", 5e-3, 5e-4), ("batch_stats", 1e-2, 2e-3)):
        got = dict(_leaves(port_state[collection]))
        want = dict(_leaves(jax_state[collection]))
        assert got.keys() == want.keys()
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=rtol, atol=atol, err_msg=key)


@pytest.mark.cuda
def test_cuda_tower_remat_equal_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the pool kernel has no CPU mode")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        x = torch.randint(0, 255, (6, 3, 96, 96), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0)).cuda()
        scale, offset = torch.full((3,), 1 / 255.0).cuda(), torch.zeros(3).cuda()
        runs = []
        for remat in (False, True):
            tower = BNInception(3, pool_impl="pallas")
            tower.reset_parameters(torch.Generator().manual_seed(0))
            tower = tower.cuda().train()
            args = (x, torch.bfloat16, scale, offset)
            y = layers.rematerialized(tower, *args) if remat else tower(*args)
            y.float().square().sum().backward()
            runs.append(({n: p.grad for n, p in tower.named_parameters() if p.grad is not None},
                         {n: b for n, b in tower.named_buffers() if "running_" in n}))
        (grads, stats), (r_grads, r_stats) = runs
        assert all(torch.equal(r_grads[n], g) for n, g in grads.items())
        assert all(torch.equal(r_stats[n], s) for n, s in stats.items())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
