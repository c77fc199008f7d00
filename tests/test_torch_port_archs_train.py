"""Training, export and the entry points with the ResNet and VGG towers of
the port, against the JAX package where it has the same function:

* the whole train step: ResNet-18 RGB + Audio (attention off, Fusion),
  64-px crops, 2 segments, float32, Fusion dropout 0, the default recipe
  otherwise (SGD momentum 0.9, lr 1e-2, grad clip 20, ``partialbn``, which
  these towers ignore: every tower parameter trains), against JAX's
  ``make_train_step``, with the tiers of test_torch_port_train_step.py (its
  docstring says why): losses rtol 1e-5 at every step, the state after one
  step rtol 1e-3 / atol 1e-4, after three parameters rtol 5e-3 / atol 5e-4
  and BatchNorm statistics rtol 1e-2 / atol 2e-3;
* the VGG-11 tower alone in training, with and without BatchNorm, live
  BatchNorm with a pad-row mask, against JAX's tower: the features, every
  parameter's gradient and the running statistics (rtol 1e-4, atol 1e-4
  times the largest value; a conv bias in front of live BatchNorm, whose
  gradient is 0, within 1e-5 of its kernel's largest gradient). The
  whole-TBN VGG step is not held to JAX's: the JAX package's TBN fixes
  VGG's dropout at 0.5, whose noise the two frameworks cannot draw alike;
  the tower is compared with dropout 0 instead, and the port's dropout is
  checked on its own. (ResNet's gradients are not compared one by one: a
  ReLU whose input lies within the frameworks' 1e-5 forward difference of
  0 flips, and one flip moves a late BatchNorm bias's gradient by ~5%; its
  whole step is held to JAX's above, after the SGD update, as the
  BN-Inception step is);
* the ``partialbn`` trainable set and warning as JAX's;
* the serving export of a ResNet-18 TBN: fp32 and bf16 bundles equal to
  the eager model on their own weights, int8 storing every conv kernel as
  int8;
* ``main`` in train and test mode with ``model.arch=resnet`` on a
  synthetic fixture (checkpoint ``tbn_resnet_RGB_Audio``, its ``.pth``
  round trip, a resume from it), and in test mode with ``model.arch=vgg``.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.data import synthetic
from attention_based_tbn_tpu.models.tbn import TBNModel as JaxTBNModel
from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu.models.vgg import VGG as JaxVGG
from attention_based_tbn_tpu.parallel import optim as jax_optim
from attention_based_tbn_tpu.parallel.optim import build_optimizer
from attention_based_tbn_tpu.parallel.train_step import TrainState as JaxTrainState
from attention_based_tbn_tpu.parallel.train_step import make_train_step as jax_make_train_step
from attention_based_tbn_tpu_torch import main as port_main
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.models.bridge import kernel_keys, state_dict_to_jax
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.models.tbn import TBNModel, TBNSpec
from attention_based_tbn_tpu_torch.models.vgg import VGG
from attention_based_tbn_tpu_torch.parallel.optim import freeze_labels
from attention_based_tbn_tpu_torch.parallel.train_step import (
    TrainState, create_train_state, make_train_step,
)
from attention_based_tbn_tpu_torch.tools import export
from attention_based_tbn_tpu_torch.tools.serve import BundleModel
from attention_based_tbn_tpu_torch.tools.train import checkpoint_stem
from attention_based_tbn_tpu_torch.utils import checkpoint
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from test_torch_port_archs import RESNET18, randomize, rel_rmse, tower_variables
from torch_port_helpers import configs, make_batch, one_torch_thread  # noqa: F401

STEP_OVERRIDES = RESNET18 + ["data.flow.enable=false", "model.fusion_dropout=0",
                             "data.train_crop_size=64"]
B = 3
STEPS = ((B - 1, 1), (B, 2), (B, 3))  # (true batch size, seed): a pad row first


def _targets(seed):
    rng = np.random.default_rng(100 + seed)
    return {"class": {"verb": rng.integers(0, 125, B).astype(np.int32),
                      "noun": rng.integers(0, 352, B).astype(np.int32)}}


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    cfg, jcfg = configs(STEP_OVERRIDES)
    model = randomize(build_model(cfg, get_modality(cfg), device="cpu"))
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    data = [(make_batch(cfg, b=B, seed=seed), _targets(seed), tb) for tb, seed in STEPS]

    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    port_losses, port_states = [], []
    for batch, targets, tb in data:
        state, loss, _ = step(state, batch, targets, 0, tb)
        port_losses.append({k: float(v) for k, v in loss.items()})
        port_states.append(state_dict_to_jax({k: v.clone() for k, v in model.state_dict().items()}))

    jmodel = JaxTBNModel(JaxTBNSpec.from_config(jcfg, get_modality(jcfg)))
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
def test_resnet_losses_match_jax(runs, step):
    got, want = runs["port_losses"][step], runs["jax_losses"][step]
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)


TIERS = [(0, "params", 1e-3, 1e-4), (0, "batch_stats", 1e-3, 1e-4),
         (2, "params", 5e-3, 5e-4), (2, "batch_stats", 1e-2, 2e-3)]


@pytest.mark.parametrize("after,collection,rtol,atol", TIERS)
def test_resnet_state_matches_jax(runs, after, collection, rtol, atol):
    got = _leaves(runs["port_states"][after][collection])
    want = _leaves(runs["jax_states"][after][collection])
    start = _leaves(runs["initial"][collection])
    assert set(got) == set(want)
    moved = 0
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=rtol, atol=atol, err_msg=key)
        moved += not np.array_equal(w, start[key])
    # the state moved (two BatchNorm scales of the Audio tower's last
    # stage have an exactly zero gradient on these batches, on both sides)
    assert moved > 0.95 * len(want)
    if collection == "params":
        assert not np.array_equal(got["Base_RGB/layer2_0/bn2/scale"],
                                  start["Base_RGB/layer2_0/bn2/scale"])


TOWER_CASES = {  # case: (port tower, JAX tower, input (B, H, W, C))
    "vgg11": (lambda: VGG(3, "11"), lambda: JaxVGG(vgg_type="11", dropout_rate=0.0),
              (3, 32, 32, 3)),
    "vgg11_bn": (lambda: VGG(3, "11_bn"), lambda: JaxVGG(vgg_type="11_bn", dropout_rate=0.0),
                 (3, 32, 32, 3)),
}


def _close(got, want, err_msg):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()),
                               err_msg=err_msg)


@pytest.mark.parametrize("case", sorted(TOWER_CASES))
def test_tower_training_matches_jax(case):
    """Train-mode features, gradients of a seeded projection of them, and
    the updated running statistics, with the last row masked out."""
    make_port, make_jax, shape = TOWER_CASES[case]
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    proj = rng.standard_normal((shape[0], 1)).astype(np.float32)
    mask = np.array([1.0] * (shape[0] - 1) + [0.0], np.float32)
    tower = make_port()
    tower.dropout_rate = 0.0  # as the JAX tower's
    tower.reset_parameters(torch.Generator().manual_seed(0))
    randomize(tower)
    variables = tower_variables(tower)
    tower.train()
    feats = tower(torch.from_numpy(x).permute(0, 3, 1, 2), torch.float32,
                  torch.from_numpy(mask))
    (feats * torch.from_numpy(proj)).sum().backward()

    jax_tower = make_jax()

    def loss(params, stats):
        out, new = jax_tower.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                   True, jnp.asarray(mask), mutable=["batch_stats"])
        return jnp.sum(out * proj), (out, new["batch_stats"])

    grads, (jfeats, jstats) = jax.grad(loss, has_aux=True)(
        variables["params"], variables.get("batch_stats", {}))
    _close(feats.detach().numpy(), np.asarray(jfeats), "features")
    # the gradients in the parameters' places of the state dict (its
    # statistics tell the bridge VGG's BatchNorm)
    grads_sd = {name: p.grad for name, p in tower.named_parameters()}
    port_grads = state_dict_to_jax({f"Base_X.{k}": grads_sd.get(k, v)
                                    for k, v in tower.state_dict().items()})["params"]["Base_X"]
    want_grads = _leaves(grads)
    got_grads = _leaves(port_grads)
    assert set(got_grads) == set(want_grads)
    for key, w in want_grads.items():
        if case.endswith("_bn") and key.startswith("conv") and key.endswith("/bias"):
            # a conv bias in front of live BatchNorm: its gradient is 0, the
            # frameworks' rounding noise is ~1e-7 of the kernel's
            bound = 1e-5 * np.abs(want_grads[key[:-len("bias")] + "kernel"]).max()
            assert np.abs(got_grads[key]).max() <= bound and np.abs(w).max() <= bound, key
            continue
        _close(got_grads[key], w, key)
    got_stats = _leaves(tower_variables(tower).get("batch_stats", {}))
    want_stats = _leaves(jstats)
    assert set(got_stats) == set(want_stats)
    for key, w in want_stats.items():
        _close(got_stats[key], w, key)


def test_vgg_dropout_draws_from_the_generator():
    """The classifier's two dropouts (rate 0.5) draw from the forward's
    generator: the same seed gives the same features, another seed others;
    about half of each stage's units are dropped; eval draws nothing."""
    tower = VGG(3, "11")
    tower.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    tower.train()
    with torch.no_grad():
        a = tower(x, torch.float32, generator=torch.Generator().manual_seed(5))
        b = tower(x, torch.float32, generator=torch.Generator().manual_seed(5))
        c = tower(x, torch.float32, generator=torch.Generator().manual_seed(6))
        tower.eval()
        gen = torch.Generator().manual_seed(5)
        state = gen.get_state()
        d = tower(x, torch.float32, generator=gen)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.25 < (a == 0).float().mean().item() < 0.95
    assert torch.equal(gen.get_state(), state) and (d > 0).any()


@pytest.mark.parametrize("arch", ["resnet", "vgg"])
def test_partialbn_trains_every_tower_parameter_as_jax(arch, caplog):
    cfg, jcfg = configs([f"model.arch={arch}", "model.resnet.depth=18", "model.vgg.type=11",
                         "model.attention.enable=false", "data.audio.enable=false"])
    assert cfg.model.freeze_mode == "partialbn" and cfg.model.freeze_base
    with torch.device("meta"):
        model = TBNModel(TBNSpec.from_config(cfg, get_modality(cfg)))
    with caplog.at_level(logging.WARNING):
        labels = freeze_labels(model, cfg)
    assert set(labels.values()) == {"train"}
    variables = state_dict_to_jax({k: np.broadcast_to(np.float32(0), v.shape)
                                   for k, v in model.state_dict().items()})
    with caplog.at_level(logging.WARNING):
        jlabels = jax_optim._freeze_labels(variables["params"], jcfg, get_modality(jcfg))
    assert set(jax.tree.leaves(jlabels)) == {"train"}
    warnings = [r.getMessage() for r in caplog.records if "partialbn" in r.getMessage()]
    assert len(warnings) == 2 and warnings[0] == warnings[1]
    assert f"arch={arch!r} trains ALL tower parameters" in warnings[0]


EXPORT_OVERRIDES = RESNET18 + ["data.flow.enable=false"]


@pytest.fixture(scope="module")
def resnet_bundles(tmp_path_factory):
    """A ResNet-18 RGB + Audio TBN exported fp32 (batch 2, bucket 1; the
    eager model itself, run just before and just after), bf16 and int8
    (batch 2)."""
    torch.set_num_threads(1)
    cfg, _ = configs(EXPORT_OVERRIDES)
    model = randomize(build_model(cfg, get_modality(cfg), device="cpu"))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    batch = make_batch(cfg, b=2, seed=9)
    dirs, eager = {}, {}
    for name, dtype, buckets in (("fp32", None, [1]), ("bf16", "bfloat16", None),
                                 ("int8", "int8", None)):
        dirs[name] = str(tmp_path_factory.mktemp(name))
        state = TrainState(model, None, None) if name == "fp32" else weights
        if name == "fp32":
            eager["before"] = _forward(model, batch)
        export.export_inference(cfg, get_modality(cfg), state=state, out_dir=dirs[name],
                                batch_size=2, serving_dtype=dtype, batch_buckets=buckets,
                                device="cpu")
        if name == "fp32":
            with torch.no_grad():
                eager["after"] = model({k: torch.from_numpy(v) for k, v in batch.items()})
    return cfg, model, weights, dirs, eager


def _forward(model, batch):
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    return {k: v.float().numpy() for k, v in out.items()}


def test_eager_forward_after_export_is_real_and_unchanged(resnet_bundles):
    """An export traces the towers' caches (the casts, the BatchNorm
    affines) on fake tensors; none may keep one, or the next eager forward
    returns fake tensors."""
    *_, eager = resnet_bundles
    for key, value in eager["after"].items():
        assert type(value) is torch.Tensor, (key, type(value))
        np.testing.assert_array_equal(value.float().numpy(), eager["before"][key], err_msg=key)


def _eager(cfg, state, batch):
    model = build_model(cfg, get_modality(cfg), device="cpu")
    model.load_state_dict(state, strict=True)
    return _forward(model, batch)


def test_resnet_fp32_bundle_equals_eager(resnet_bundles):
    cfg, model, weights, dirs, _ = resnet_bundles
    bundle = BundleModel(dirs["fp32"], device="cpu")
    assert bundle.manifest["arch"] == "resnet"
    for b in (2, 1):
        batch = make_batch(cfg, b=b, seed=10 + b)
        got = bundle.predict(batch)
        assert bundle.last_bucket == b
        want = _eager(cfg, weights, batch)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_resnet_bf16_bundle_equals_eager_on_its_weights(resnet_bundles):
    """The bf16 bundle casts the kernels only; against the eager model on
    those weights (widened), within rel-RMSE 1e-6: the same ops, and the
    float32 forward of bf16-exact kernels."""
    cfg, _, _, dirs, _ = resnet_bundles
    stored = torch.load(os.path.join(dirs["bf16"], "params.pt"), weights_only=True)
    cast = {k for k, v in stored.items() if v.dtype == torch.bfloat16}
    assert cast == kernel_keys(stored)
    batch = make_batch(cfg, b=2, seed=13)
    got = BundleModel(dirs["bf16"], device="cpu").predict(batch)
    want = _eager(cfg, {k: v.float() if v.dtype == torch.bfloat16 else v
                        for k, v in stored.items()}, batch)
    for key in want:
        assert rel_rmse(got[key], want[key]) < 1e-6, key


def test_resnet_int8_bundle_quantizes_every_conv(resnet_bundles):
    cfg, model, weights, dirs, _ = resnet_bundles
    stored = torch.load(os.path.join(dirs["int8"], "params.pt"), weights_only=True)
    quantized = {k for k, v in stored.items() if isinstance(v, dict)}
    convs = {f"{name}.weight" for name, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d)}
    assert len(convs) == 2 * 20
    assert convs <= quantized and quantized == kernel_keys(weights)
    assert all(stored[k]["q"].dtype == torch.int8 for k in quantized)
    batch = make_batch(cfg, b=2, seed=14)
    got = BundleModel(dirs["int8"], device="cpu").predict(batch)
    want = _eager(cfg, export.dequantize(stored), batch)
    for key in want:
        assert rel_rmse(got[key], want[key]) < 1e-6, key


VIDEOS = ["P01_01", "P02_03"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_archs_main"))
    synthetic.generate(root, videos=VIDEOS, frames_per_video=60, actions_per_video=3,
                       image_hw=(72, 96), num_verbs=7, num_nouns=9)
    return root


def _main_overrides(root, exp, *extra):
    split = os.path.join(root, "train_split.txt")
    return [
        f"data_dir={root}", f"out_dir={root}/out", f"exp_name={exp}", "num_workers=2",
        "tpu.platform=cpu", "data.flow.enable=false", "data.audio.audio_length=1.279",
        "data.train_scale_size=72", "data.train_crop_size=64", "data.test_scale_size=72",
        "data.test_crop_size=64", "model.num_classes={verb: 7, noun: 9}",
        "model.pretrained=false", "tpu.compute_dtype=float32", f"train.vid_list={split}",
        "train.batch_size=3", "train.num_segments=2", f"val.vid_list={split}",
        "val.batch_size=3", "val.num_segments=2", "test.num_segments=2",
        f"test.vid_list={split}", "test.annotation_file=[annotations/epic_train_val.csv]",
        "model.attention.enable=false", *extra,
    ]


@pytest.fixture(scope="module")
def resnet_main(fixture_root):
    """main: train ResNet-18 RGB + Audio 1 epoch, then test from its .pth."""
    torch.set_num_threads(1)
    stem = os.path.join(fixture_root, "out", "tbn_weights", "resnet", "epic_tbn_resnet_RGB_Audio")
    over = _main_overrides(fixture_root, "resnet", "model.arch=resnet", "model.resnet.depth=18",
                           "train.enable=true", "train.epochs=1", "test.enable=true",
                           f"test.pre_trained={stem}.pth")
    results = port_main.main(over)
    return load_config(overrides=over), stem, results


def test_main_trains_and_tests_a_resnet(resnet_main):
    cfg, stem, results = resnet_main
    assert stem == checkpoint_stem(cfg, ["RGB", "Audio"])
    assert os.path.isfile(stem + ".pth")
    (test_loss, test_acc, _), = results
    assert np.isfinite(test_loss["total"]) and set(test_acc) == {"verb", "noun", "all_class"}


def test_resnet_checkpoint_round_trips(resnet_main):
    """The .pth reloads into a fresh train state: the weights and the
    momentum buffers equal the file's, the history says epoch 0."""
    cfg, stem, _ = resnet_main
    data = torch.load(stem + ".pth", map_location="cpu", weights_only=True)
    assert any(k.startswith("Base_Audio.model.layer4.") for k in data["model"])
    state = create_train_state(cfg, build_model(cfg, ["RGB", "Audio"], device="cpu", seed=3))
    state, history = checkpoint.restore_checkpoint(stem + ".pth", state)
    assert history["epoch"] == 0
    own = state.model.state_dict()
    assert set(own) == set(data["model"])
    for key, value in data["model"].items():
        assert torch.equal(own[key], value), key
    saved = data["optimizer"]["inner"]["state"]
    restored = state.optimizer.state_dict()["inner"]["state"]
    assert saved and set(saved) == set(restored)
    for idx, entry in saved.items():
        assert torch.equal(restored[idx]["momentum_buffer"], entry["momentum_buffer"])


def test_main_resumes_a_resnet_run(resnet_main, fixture_root):
    """main in train mode again from the .pth, under another experiment
    name: training continues at epoch 2 and the new history holds both
    epochs."""
    _, stem, _ = resnet_main
    over = _main_overrides(fixture_root, "resumed", "model.arch=resnet", "model.resnet.depth=18",
                           "train.enable=true", "train.epochs=1", "test.enable=false",
                           f"train.pre_trained={stem}.pth")
    port_main.main(over)
    log_dir = os.path.join(fixture_root, "out", "log", "resumed")
    run_dir = os.path.join(log_dir, os.listdir(log_dir)[0])
    with open(os.path.join(run_dir, "tbn_RGB_Audio.log")) as fh:
        assert "Model will continue training from epoch no 2" in fh.read()
    resumed = checkpoint_stem(load_config(overrides=over), ["RGB", "Audio"])
    with open(resumed + ".history.json") as fh:
        history = json.load(fh)
    assert history["epoch"] == 1 and len(history["train_loss"]) == 2


def test_main_tests_a_vgg(fixture_root, tmp_path):
    """main in test mode with VGG-11 RGB at 32-px crops from a seeded .pth."""
    over = _main_overrides(fixture_root, "vgg", "model.arch=vgg", "model.vgg.type=11",
                           "data.audio.enable=false", "data.test_scale_size=40",
                           "data.test_crop_size=32", "train.enable=false", "test.enable=true",
                           f"test.pre_trained={tmp_path}/vgg.pth")
    cfg = load_config(overrides=over)
    torch.save({"model": build_model(cfg, ["RGB"], device="cpu", seed=4).state_dict()},
               tmp_path / "vgg.pth")
    (test_loss, test_acc, _), = port_main.main(over)
    assert np.isfinite(test_loss["total"]) and set(test_acc) == {"verb", "noun", "all_class"}
