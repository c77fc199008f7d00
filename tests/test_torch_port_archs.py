"""The ResNet and VGG tower families of the port (``model.arch=resnet|vgg``)
against the JAX package, eval and weights, with the weights carried between
the two by the port's bridge (models/bridge.py):

* towers: ResNet-18 / 50 (RGB and a 1-channel spectrogram patch) and
  VGG-11 with and without BatchNorm (32 px: the 7 x 7 adaptive pool
  repeats cells) against JAX's ``ResNet`` / ``VGG``, BatchNorm affine and
  statistics randomized;
* structure by shapes only: ResNet-34/101/152 and VGG-16/16bn, the port's
  state dict (built on the meta device) against the JAX exporter's keys
  and shapes on ``jax.eval_shape``'s tree;
* ``ops/pooling.adaptive_avg_pool2d`` against JAX's;
* the whole TBN: ResNet-18 RGB + Flow + Audio (attention off) against JAX's
  ``TBNModel``, plain and fast consensus, fp32 and bf16, and 10-crop;
  VGG-11 RGB alone at 32 px;
* the bridge's round trips and ``kernel_keys``, seeded torchvision-layout
  pretrained files against JAX's ``load_pretrained_towers``, a JAX-exported
  reference checkpoint loaded strict, and the refusals.

Tolerances: fp32 features and logits rtol 1e-4 with atol 1e-4 times the
largest value (the convolutions sum in other orders); bf16 within
tests/test_bf16_drift.py's rel-RMSE 0.04 of JAX's bf16 forward; the
adaptive pool rtol 1e-6 / atol 1e-6 (a float32 mean of at most 4 x 4
cells); weights and pretrained files exactly, an adapted first conv within
one float32 ulp.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.models import builder as jax_builder
from attention_based_tbn_tpu.models import convert as jax_convert
from attention_based_tbn_tpu.models import convert_back as jax_convert_back
from attention_based_tbn_tpu.models.resnet import ResNet as JaxResNet
from attention_based_tbn_tpu.models.tbn import TBNModel as JaxTBNModel
from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu.models.vgg import VGG as JaxVGG
from attention_based_tbn_tpu.models.vgg import vgg_base_type as jax_vgg_base_type
from attention_based_tbn_tpu.ops.pooling import adaptive_avg_pool2d as jax_adaptive_avg_pool2d
from attention_based_tbn_tpu_torch.models import builder
from attention_based_tbn_tpu_torch.models.bridge import (
    jax_to_state_dict, kernel_keys, state_dict_to_jax,
)
from attention_based_tbn_tpu_torch.models.resnet import ResNet
from attention_based_tbn_tpu_torch.models.tbn import TBNModel, TBNSpec
from attention_based_tbn_tpu_torch.models.vgg import VGG, vgg_base_type
from attention_based_tbn_tpu_torch.ops.pooling import adaptive_avg_pool2d
from attention_based_tbn_tpu_torch.utils.checkpoint import load_eval_weights
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from torch_port_helpers import configs, make_batch, one_torch_thread  # noqa: F401

DRIFT_REL_RMSE = 0.04  # tests/test_bf16_drift.py
RESNET18 = ["model.arch=resnet", "model.resnet.depth=18", "model.attention.enable=false"]


def rel_rmse(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2)) / (np.sqrt(np.mean(want ** 2)) + 1e-12))


def assert_close_scaled(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()),
                               err_msg=err_msg)


@torch.no_grad()
def randomize(model, seed=1):
    """Random BatchNorm affine and statistics and biases (convs, linears),
    so that eval BatchNorm is not the identity."""
    gen = torch.Generator().manual_seed(seed)
    for module in model.modules():
        if isinstance(module, torch.nn.BatchNorm2d):
            module.weight.copy_(torch.rand(module.weight.shape, generator=gen) + 0.5)
            module.running_var.copy_(torch.rand(module.weight.shape, generator=gen) + 0.5)
            module.running_mean.copy_(torch.randn(module.weight.shape, generator=gen) * 0.1)
            module.bias.copy_(torch.randn(module.weight.shape, generator=gen) * 0.1)
        elif isinstance(module, (torch.nn.Conv2d, torch.nn.Linear)) and module.bias is not None:
            module.bias.copy_(torch.randn(module.bias.shape, generator=gen) * 0.1)
    return model


def tower_variables(tower):
    """A port tower's weights as the JAX tower's variables (copies: a
    training forward updates the statistics in place)."""
    variables = state_dict_to_jax({f"Base_X.{k}": v for k, v in tower.state_dict().items()})
    return {k: jax.tree.map(np.array, v["Base_X"]) for k, v in variables.items() if "Base_X" in v}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


TOWERS = {  # case: (port tower, JAX tower, input (B, H, W, C))
    "resnet18": (lambda c: ResNet(c, 18), lambda: JaxResNet(depth=18), (2, 64, 64, 3)),
    "resnet18_audio": (lambda c: ResNet(c, 18), lambda: JaxResNet(depth=18), (2, 64, 100, 1)),
    "resnet50": (lambda c: ResNet(c, 50), lambda: JaxResNet(depth=50), (2, 64, 64, 3)),
    "vgg11": (lambda c: VGG(c, "11"), lambda: JaxVGG(vgg_type="11"), (2, 32, 32, 3)),
    "vgg11_bn": (lambda c: VGG(c, "11_bn"), lambda: JaxVGG(vgg_type="11_bn"), (2, 32, 32, 3)),
}


@pytest.mark.parametrize("case", sorted(TOWERS))
def test_tower_features_match_jax(case):
    make_port, make_jax, shape = TOWERS[case]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    tower = make_port(shape[-1]).eval()
    tower.reset_parameters(torch.Generator().manual_seed(0))
    randomize(tower)
    with torch.no_grad():
        got = tower(_nchw(x), torch.float32).numpy()
    jax_tower = make_jax()
    want = np.asarray(jax.jit(lambda v, a: jax_tower.apply(v, a, False))(
        tower_variables(tower), jnp.asarray(x)))
    assert got.shape == want.shape == (shape[0], tower.feature_size)
    assert_close_scaled(got, want)


def _shape_tree(tree):
    """``jax.eval_shape`` leaves as zero-size-stride float32 arrays."""
    return jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), tree)


STRUCTURES = {  # case: (port tower, JAX tower, JAX exporter)
    "resnet34": (lambda: ResNet(3, 34), JaxResNet(depth=34), jax_convert_back.export_resnet),
    "resnet101": (lambda: ResNet(3, 101), JaxResNet(depth=101), jax_convert_back.export_resnet),
    "resnet152": (lambda: ResNet(3, 152), JaxResNet(depth=152), jax_convert_back.export_resnet),
    "vgg16": (lambda: VGG(3, "16"), JaxVGG(vgg_type="16"),
              lambda p, s: jax_convert_back.export_vgg(p, s, "16")),
    "vgg16bn": (lambda: VGG(3, "16bn"), JaxVGG(vgg_type="16bn"),
                lambda p, s: jax_convert_back.export_vgg(p, s, "16bn")),
}


@pytest.mark.parametrize("case", sorted(STRUCTURES))
def test_structure_matches_the_jax_exporter(case):
    """Parameter and buffer names and shapes, from shapes alone: the port's
    tower on the meta device, JAX's from jax.eval_shape through its
    exporter (the reference state dict under ``model.``)."""
    make_port, jax_tower, export = STRUCTURES[case]
    with torch.device("meta"):
        tower = make_port()
    got = {k: tuple(v.shape) for k, v in tower.state_dict().items()}
    shapes = jax.eval_shape(lambda: jax_tower.init(jax.random.key(0),
                                                   jnp.zeros((1, 32, 32, 3))))
    tree = _shape_tree(shapes)
    want = {f"model.{k}": tuple(np.shape(v))
            for k, v in export(tree["params"], tree.get("batch_stats", {})).items()}
    assert got == want


@pytest.mark.parametrize("hw,out", [((7, 7), (7, 7)), ((14, 28), (7, 7)), ((8, 13), (7, 7)),
                                    ((1, 1), (7, 7)), ((3, 5), (7, 4))],
                         ids=["identity", "down", "audio_8x13", "up_1x1", "mixed"])
def test_adaptive_avg_pool2d_matches_jax(hw, out):
    x = np.random.default_rng(1).standard_normal((2, 3) + hw).astype(np.float32)
    got = adaptive_avg_pool2d(torch.from_numpy(x), out).numpy()
    want = np.asarray(jax_adaptive_avg_pool2d(jnp.asarray(x.transpose(0, 2, 3, 1)), out))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=1e-6, atol=1e-6)
    if hw == out:  # returned as it came
        x_t = torch.from_numpy(x)
        assert adaptive_avg_pool2d(x_t, out) is x_t


def jax_tbn_forward(jcfg, state_dict, batch, variables=None):
    """JAX's eval forward on a port state dict (or on Flax ``variables``)."""
    model = JaxTBNModel(JaxTBNSpec.from_config(jcfg, get_modality(jcfg)))
    variables = jax.tree.map(jnp.asarray, variables or state_dict_to_jax(state_dict))
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def port_tbn(cfg, seed=0):
    return randomize(builder.build_model(cfg, get_modality(cfg), device="cpu", seed=seed))


def port_forward(model, batch):
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    return {k: v.float().numpy() for k, v in out.items()}


WHOLE = {  # case: (overrides, crops)
    "fp32": ([], 1),
    "fp32_fast_consensus": (["tpu.fast_consensus=true", "tpu.use_pallas=true"], 1),
    "fp32_ten_crop": (["tpu.fast_consensus=true"], 10),
    "bf16": (["tpu.compute_dtype=bfloat16"], 1),
    "bf16_fast_consensus": (["tpu.compute_dtype=bfloat16", "tpu.fast_consensus=true",
                             "tpu.use_pallas=true"], 1),
}


@pytest.mark.parametrize("case", sorted(WHOLE))
def test_resnet18_tbn_matches_jax(case):
    """RGB + Flow + Audio ResNet-18 towers, Fusion and the heads. The
    kernels' route (``tpu.use_pallas``) runs the consensus_heads wrapper's
    plain version on the CPU; the JAX package runs its jnp consensus."""
    over, crops = WHOLE[case]
    cfg, jcfg = configs(RESNET18 + over)
    model = port_tbn(cfg)
    assert model.fusion.fusion_layer[0].in_features == 3 * 512
    batch = make_batch(cfg, b=2, seed=3, crops=crops)
    got = port_forward(model, batch)
    want = jax_tbn_forward(jcfg, model.state_dict(), batch)
    assert set(got) == set(want) == {"verb", "noun"}
    for key in want:
        assert got[key].shape == want[key].shape == (2, dict(cfg.model.num_classes)[key])
        assert np.isfinite(got[key]).all()
        if "bf16" in case:
            assert rel_rmse(got[key], want[key]) < DRIFT_REL_RMSE, key
        else:
            assert_close_scaled(got[key], want[key], key)


def test_vgg11_rgb_tbn_matches_jax():
    """One VGG case: RGB alone (no Fusion: the heads take the 4096 features)
    at 32 px, fp32."""
    cfg, jcfg = configs(["model.arch=vgg", "model.vgg.type=11", "model.attention.enable=false",
                         "data.flow.enable=false", "data.audio.enable=false",
                         "data.test_crop_size=32"])
    model = port_tbn(cfg)
    assert model.classifier["verb"].in_features == 4096
    batch = make_batch(cfg, b=2, seed=4)
    got = port_forward(model, batch)
    want = jax_tbn_forward(jcfg, model.state_dict(), batch)
    for key in ("verb", "noun"):
        assert_close_scaled(got[key], want[key], key)


@pytest.mark.parametrize("over,width", [
    (["model.resnet.depth=34"], 3 * 512), (["model.resnet.depth=50"], 3 * 2048),
    (["model.resnet.depth=101", "data.rgb.enable=false", "data.audio.enable=false"], 2048),
    (["model.arch=vgg"], 3 * 4096),
], ids=["resnet34", "resnet50", "resnet101_flow", "vgg16"])
def test_fusion_input_width_follows_the_arch(over, width):
    cfg, jcfg = configs(["model.arch=resnet", "model.attention.enable=false"] + over)
    with torch.device("meta"):
        model = TBNModel(TBNSpec.from_config(cfg, get_modality(cfg)))
    head_in = (model.fusion.fusion_layer[0].in_features if model.spec.multimodal
               else model.classifier["verb"].in_features)
    assert head_in == width
    jmodel = JaxTBNModel(JaxTBNSpec.from_config(jcfg, get_modality(jcfg)))
    assert sum(model.feature_size(m) for m in get_modality(cfg)) == sum(
        jmodel.feature_size(m) for m in get_modality(jcfg)) == width


@pytest.mark.parametrize("vgg_type", ["11", "16", "16bn", "11_bn", "16_bn"])
def test_vgg_type_spellings_as_jax(vgg_type):
    assert vgg_base_type(vgg_type) == jax_vgg_base_type(vgg_type)
    with torch.device("meta"):
        tower = VGG(3, vgg_type)
    has_bn = any(isinstance(m, torch.nn.BatchNorm2d) for m in tower.modules())
    assert has_bn == vgg_type.endswith("bn")


BRIDGE_CASES = {
    "resnet18": RESNET18,
    "vgg11_bn": ["model.arch=vgg", "model.vgg.type=11_bn", "model.attention.enable=false",
                 "data.flow.enable=false", "data.audio.enable=false"],
    "vgg11": ["model.arch=vgg", "model.vgg.type=11", "model.attention.enable=false",
              "data.rgb.enable=false", "data.audio.enable=false"],
}


@pytest.mark.parametrize("case", sorted(BRIDGE_CASES))
def test_bridge_round_trip(case):
    """state dict -> Flax variables -> state dict, exactly; the variables'
    tree is the one JAX's model declares (its eval_shape)."""
    cfg, jcfg = configs(BRIDGE_CASES[case])
    model = port_tbn(cfg)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = state_dict_to_jax(sd)
    back = jax_to_state_dict(variables, model.spec)
    assert set(back) == set(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    jmodel = JaxTBNModel(JaxTBNSpec.from_config(jcfg, get_modality(jcfg)))
    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg, b=1).items()}
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), batch))
    for collection in ("params", "batch_stats"):
        want = jax.tree.map(lambda s: s.shape, shapes.get(collection, {}))
        got = jax.tree.map(np.shape, variables[collection])
        assert got == want, collection


@pytest.mark.parametrize("case", ["resnet18", "vgg11_bn"])
def test_kernel_keys_are_the_conv_and_dense_weights(case):
    cfg, _ = configs(BRIDGE_CASES[case])
    with torch.device("meta"):
        model = TBNModel(TBNSpec.from_config(cfg, get_modality(cfg)))
    want = {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))}
    assert kernel_keys(model.state_dict()) == want
    n_convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert n_convs == (3 * 20 if case == "resnet18" else 8)


def _torchvision_file(tower, head: str, classes: int, seed: int) -> dict:
    """A seeded torchvision-layout state dict of a port tower's body, with
    the ImageNet head and batch counters torchvision saves."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, value in tower.model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(7)
        elif key.endswith("running_var") or key.endswith("bn1.weight"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.5, value.shape).astype(np.float32))
        else:
            sd[key] = torch.from_numpy((rng.standard_normal(value.shape) * 0.05)
                                       .astype(np.float32))
    width = 512 if head == "fc" else 4096
    sd[f"{head}.weight"] = torch.from_numpy(rng.standard_normal((classes, width))
                                            .astype(np.float32))
    sd[f"{head}.bias"] = torch.zeros(classes)
    return sd


PRETRAINED = {  # case: (overrides, file stem, head key)
    "resnet18": (RESNET18, "resnet18", "fc"),
    "vgg11_flow": (["model.arch=vgg", "model.vgg.type=11", "model.attention.enable=false",
                    "data.rgb.enable=false", "data.audio.enable=false"], "vgg11", "classifier.6"),
}


@pytest.mark.parametrize("case", sorted(PRETRAINED))
def test_pretrained_torchvision_files_load_as_jax(tmp_path, case):
    over, stem, head = PRETRAINED[case]
    cfg, jcfg = configs([f"model.weights_dir={tmp_path}"] + over)
    modality = get_modality(cfg)
    model = builder.build_model(cfg, modality, device="cpu")
    rgb_tower = ResNet(3, 18) if stem.startswith("resnet") else VGG(3, "11")
    torch.save(_torchvision_file(rgb_tower, head, 1000, seed=5), tmp_path / f"{stem}.pth")
    del rgb_tower
    start = state_dict_to_jax(model.state_dict())
    logger = logging.getLogger("port_archs")
    loaded = builder.load_pretrained_towers(cfg, modality, model, logger)
    assert loaded == {f"Base_{m}": str(tmp_path / f"{stem}.pth") for m in modality}
    params, stats = jax_builder.load_pretrained_towers(
        jcfg, modality, start["params"], start["batch_stats"], logger)
    want = jax_to_state_dict({"params": params, "batch_stats": stats}, model.spec)
    got = model.state_dict()
    first = "model.conv1.weight" if head == "fc" else "model.features.0.weight"
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        g = got[key].numpy()
        if key.endswith(first) and not key.startswith("Base_RGB"):
            np.testing.assert_array_max_ulp(g, value.astype(g.dtype), maxulp=1)
        else:
            np.testing.assert_array_equal(g, value, err_msg=key)
    if "Base_Flow" in loaded:
        assert got[f"Base_Flow.{first}"].shape[1] == 10
    if "Base_Audio" in loaded:
        assert got[f"Base_Audio.{first}"].shape[1] == 1


def test_jax_exported_reference_checkpoint_loads_strict(tmp_path):
    """JAX's ``convert_back.save_reference_checkpoint`` of ResNet-18 TBN
    weights (``Base_<m>.model.`` keys) loads into the port with no key left
    over but the batch counters and gives JAX's logits; the stripped heads
    a reference file may still carry are tolerated."""
    cfg, jcfg = configs(RESNET18)
    source = port_tbn(cfg, seed=7)
    variables = jax.tree.map(np.asarray, state_dict_to_jax(source.state_dict()))
    spec = JaxTBNSpec.from_config(jcfg, get_modality(jcfg))
    path = str(tmp_path / "reference.pth")
    data = jax_convert_back.save_reference_checkpoint(path, variables, spec, epoch=3)
    assert any(k.startswith("Base_RGB.model.layer4.1.") for k in data["model"])
    model = builder.build_model(cfg, get_modality(cfg), device="cpu", seed=1)
    left_out = load_eval_weights(model, path)
    assert all(k.endswith("num_batches_tracked") for k in left_out["not_in_file"])
    assert left_out["not_in_model"] == []
    batch = make_batch(cfg, b=2, seed=8)
    got = port_forward(model, batch)
    params, stats = jax_convert.convert_tbn_checkpoint(data["model"], "resnet")
    want = jax_tbn_forward(jcfg, None, batch, {"params": params, "batch_stats": stats})
    for key in ("verb", "noun"):
        assert_close_scaled(got[key], want[key], key)
    # a file that kept torchvision's fc head in every tower still loads
    extra = dict(data["model"])
    for m in ("RGB", "Flow", "Audio"):
        extra[f"Base_{m}.model.fc.weight"] = torch.zeros(1000, 512)
        extra[f"Base_{m}.model.fc.bias"] = torch.zeros(1000)
    torch.save({"model": extra}, tmp_path / "with_fc.pth")
    left_out = load_eval_weights(model, str(tmp_path / "with_fc.pth"))
    assert len(left_out["not_in_model"]) == 6


@pytest.mark.parametrize("arch", ["resnet", "vgg"])
def test_audio_attention_is_refused_as_jax(arch):
    cfg, jcfg = configs([f"model.arch={arch}"])
    with pytest.raises(ValueError) as jax_error:
        JaxTBNSpec.from_config(jcfg, get_modality(jcfg)).validate()
    with pytest.raises(ValueError) as port_error:
        builder.build_model(cfg, get_modality(cfg), device="cpu")
    assert str(port_error.value) == str(jax_error.value)


def test_unknown_arch_is_refused():
    cfg, _ = configs(["model.arch=alexnet"])
    with pytest.raises(ValueError, match="Model type 'alexnet' not supported"):
        builder.build_model(cfg, get_modality(cfg), device="cpu")
    with pytest.raises(ValueError, match="Unknown arch 'alexnet'"):
        TBNSpec(arch="alexnet", attention_enable=False).validate()
    with pytest.raises(ValueError, match="model.resnet.depth=42"):
        TBNSpec(arch="resnet", resnet_depth=42, attention_enable=False).validate()
