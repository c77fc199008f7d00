"""Pretrained tower weights in the port (models/builder.load_pretrained_towers,
models/convert.py) against the JAX package's ``load_pretrained_towers``
on the same files and the same start weights, carried back to a state
dict by ``bridge.jax_to_state_dict``: pretrainedmodels ``.pth`` files
(ImageNet RGB, its conv1 averaged and tiled for Audio; Kinetics Flow with
its 400-class head), ``.npz`` towers converted by the JAX package, and both
(the ``.npz`` wins). Exact, except an adapted first conv (a mean over its
input channels), within one float32 ulp. Then the cases that keep the
seeded init: a missing file (with a warning), Audio under
``model.bninception.audio_stem``, and ``model.pretrained=false``.

Files are seeded pretrainedmodels-layout state dicts
(tests/test_convert.synth_bninception_state_dict), as
tests/test_weights_prepare.py writes them."""

import logging
import os

import numpy as np
import pytest
import torch

import jax

from attention_based_tbn_tpu.models import builder as jax_builder
from attention_based_tbn_tpu.models.convert import convert_bninception as jax_convert_bninception
from attention_based_tbn_tpu.models.convert_cli import save_npz
from attention_based_tbn_tpu_torch.models import builder
from attention_based_tbn_tpu_torch.models.bridge import jax_to_state_dict, state_dict_to_jax
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from test_convert import synth_bninception_state_dict
from torch_port_helpers import configs, one_torch_thread  # noqa: F401 (autouse fixture)

RGB, FLOW = "imagenet_bninception_rgb", "kinetics_bninception_flow"
ADAPTED_FIRST_CONV = ("Base_Audio.conv1_7x7_s2.weight", "Base_Flow.conv1_7x7_s2.weight")


def _pretrained_files(directory, fmt, seed):
    """``.pth`` and / or ``.npz`` files of both stems; with "both", the
    ``.npz`` holds other weights than the ``.pth``."""
    os.makedirs(directory, exist_ok=True)
    torch.manual_seed(seed)
    towers = {RGB: synth_bninception_state_dict(3), FLOW: synth_bninception_state_dict(10)}
    towers[FLOW]["last_linear.weight"] = torch.randn(400, 1024)
    towers[FLOW]["last_linear.bias"] = torch.randn(400)
    for stem, sd in towers.items():
        if fmt in ("pth", "both"):
            torch.save(sd, os.path.join(directory, stem + ".pth"))
        if fmt in ("npz", "both"):
            if fmt == "both":
                sd = {k: v + 1.0 for k, v in sd.items()}
            save_npz(os.path.join(directory, stem + ".npz"), *jax_convert_bninception(sd))


def _port_and_jax(directory, *over):
    cfg, jcfg = configs([f"model.weights_dir={directory}", *over])
    modality = get_modality(cfg)
    model = builder.build_model(cfg, modality, device="cpu")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    logger = logging.getLogger("port_pretrained")
    loaded = builder.load_pretrained_towers(cfg, modality, model, logger)
    variables = state_dict_to_jax(start)
    params, stats = jax_builder.load_pretrained_towers(
        jcfg, modality, variables["params"], variables["batch_stats"], logger)
    want = jax_to_state_dict({"params": jax.tree.map(np.asarray, params),
                              "batch_stats": jax.tree.map(np.asarray, stats)}, model.spec)
    return model, start, loaded, want


@pytest.mark.parametrize("fmt", ["pth", "npz", "both"])
def test_towers_match_jax(tmp_path, fmt):
    _pretrained_files(str(tmp_path), fmt, seed=0)
    model, start, loaded, want = _port_and_jax(str(tmp_path))
    suffix = ".pth" if fmt == "pth" else ".npz"
    assert loaded == {"Base_RGB": str(tmp_path / (RGB + suffix)),
                      "Base_Flow": str(tmp_path / (FLOW + suffix)),
                      "Base_Audio": str(tmp_path / (RGB + suffix))}
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        g = got[key].numpy()
        if key in ADAPTED_FIRST_CONV:
            np.testing.assert_array_max_ulp(g, value.astype(g.dtype), maxulp=1)
        else:
            np.testing.assert_array_equal(g, value, err_msg=key)
    # the towers moved, the rest kept the seeded init
    assert got["Base_Audio.conv1_7x7_s2.weight"].shape[1] == 1
    assert not torch.equal(got["Base_RGB.inception_5b_1x1.weight"],
                           start["Base_RGB.inception_5b_1x1.weight"])
    assert torch.equal(got["fusion.fusion_layer.0.weight"], start["fusion.fusion_layer.0.weight"])
    if fmt == "both":  # the .npz's weights, not the .pth's
        pth = torch.load(tmp_path / (RGB + ".pth"))
        np.testing.assert_array_equal(got["Base_RGB.conv2_3x3.bias"].numpy(),
                                      pth["conv2_3x3.bias"].numpy() + 1.0)


def test_flow_conv_adapted_to_a_shorter_window(tmp_path):
    _pretrained_files(str(tmp_path), "pth", seed=1)
    model, _, _, want = _port_and_jax(str(tmp_path), "data.flow.win_length=3",
                                      "data.rgb.enable=false", "data.audio.enable=false")
    got = model.state_dict()["Base_Flow.conv1_7x7_s2.weight"].numpy()
    assert got.shape[1] == 6
    np.testing.assert_array_max_ulp(got, want["Base_Flow.conv1_7x7_s2.weight"], maxulp=1)


def test_missing_files_warn_and_keep_the_init(tmp_path, caplog):
    model, start, loaded, want = _port_and_jax(str(tmp_path / "empty"))
    assert loaded == {}
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    for tower in ("Base_RGB", "Base_Flow", "Base_Audio"):
        assert sum(f"{tower} keeps random init" in w for w in warnings) == 2  # port and JAX
    for key, value in model.state_dict().items():
        assert torch.equal(value, start[key]), key


def test_audio_stem_skips_audio(tmp_path, caplog):
    _pretrained_files(str(tmp_path), "pth", seed=2)
    model, start, loaded, want = _port_and_jax(str(tmp_path), "model.bninception.audio_stem=true",
                                               "data.flow.enable=false")
    assert set(loaded) == {"Base_RGB"}
    assert sum("audio_stem=true" in r.getMessage() for r in caplog.records) == 2
    for key, value in model.state_dict().items():
        if key.startswith("Base_Audio."):
            assert torch.equal(value, start[key]), key
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)


def test_pretrained_false_loads_nothing(tmp_path):
    _pretrained_files(str(tmp_path), "pth", seed=3)
    model, start, loaded, want = _port_and_jax(str(tmp_path), "model.pretrained=false")
    assert loaded == {}
    for key, value in model.state_dict().items():
        assert torch.equal(value, start[key]), key
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)


def test_weights_dir_resolves_as_jax():
    for directory in ("weights", "/abs/weights"):
        cfg, jcfg = configs([f"model.weights_dir={directory}"])
        assert builder.weights_dir(cfg) == jax_builder._weights_dir(jcfg)


@pytest.mark.parametrize("over,message", [
    ("model.loss_fn=mse", "prior-loss"), ("model.loss_fn=hinge", "Loss type"),
    ("model.arch=alexnet", "Model type"), ("model.arch=resnet", "audio attention requires"),
    ("tpu.quantize=int8", "calibrate_quantization"),
])
def test_build_model_refuses_what_jax_refuses(over, message):
    cfg, jcfg = configs([over])
    with pytest.raises((ValueError, AssertionError)):
        jax_builder.build_model(jcfg, get_modality(jcfg))
    with pytest.raises(ValueError, match=message):
        builder.build_model(cfg, get_modality(cfg), device="cpu")
