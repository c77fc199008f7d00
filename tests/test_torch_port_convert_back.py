"""The port's export to the reference PyTorch checkpoint
(models/convert_back.py) and its ``.npz`` CLI (models/convert_cli.py)
against the JAX package's, on the same weights: the exported state dict key
for key and bit for bit, the written ``.pth`` read back by the port and by
the JAX package's importer, the CLI from a port training checkpoint, and
the ``.npz`` of every ``--kind``."""

import os

import numpy as np
import pytest
import torch

import jax

from attention_based_tbn_tpu.config import load_config as jax_load_config
from attention_based_tbn_tpu.models import convert_back as jax_convert_back
from attention_based_tbn_tpu.models import convert_cli as jax_convert_cli
from attention_based_tbn_tpu.models.convert import convert_tbn_checkpoint, load_torch_file
from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.models import convert_back, convert_cli
from attention_based_tbn_tpu_torch.models.bridge import state_dict_to_jax
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.parallel.train_step import create_train_state
from attention_based_tbn_tpu_torch.utils import checkpoint
from attention_based_tbn_tpu_torch.utils.misc import get_modality

from torch_port_helpers import SMALL, one_torch_thread, port_model  # noqa: F401

VARIANTS = {
    "mha": [],
    "unimodal": ["model.attention.type=unimodal"],
    "proto": ["model.attention.type=proto"],
    "resnet18": ["model.arch=resnet", "model.resnet.depth=18", "model.attention.enable=false",
                 "data.flow.enable=false"],
    "vgg11": ["model.arch=vgg", "model.vgg.type=11", "model.attention.enable=false",
              "data.flow.enable=false", "data.audio.enable=false"],
}


def _model(name):
    over = SMALL + VARIANTS[name]
    cfg = load_config(overrides=over)
    model = port_model(cfg, seed=3) if name != "vgg11" else build_model(
        cfg, get_modality(cfg), device="cpu", seed=3)
    jcfg = jax_load_config(overrides=over)
    return cfg, model, JaxTBNSpec.from_config(jcfg, get_modality(jcfg))


def _assert_state_dicts_equal(got, want):
    """Same keys, and each tensor of the same dtype, shape and bits."""
    assert set(got) == set(want)
    for key, value in want.items():
        g = got[key].numpy() if isinstance(got[key], torch.Tensor) else np.asarray(got[key])
        w = value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert np.array_equal(g, w), key


@pytest.mark.parametrize("name", list(VARIANTS))
def test_export_equals_jax_bit_for_bit(name):
    cfg, model, jspec = _model(name)
    got = convert_back.export_tbn_state_dict(model, model.spec)
    want = jax_convert_back.export_tbn_state_dict(state_dict_to_jax(model.state_dict()), jspec)
    _assert_state_dicts_equal(got, want)
    assert all(v.device.type == "cpu" for v in got.values())
    # from the state dict alone, without the regenerated buffers: the same
    bare = {k: v for k, v in model.state_dict().items() if not checkpoint.tolerated_key(k)}
    _assert_state_dicts_equal(convert_back.export_tbn_state_dict(bare, model.spec), want)


@pytest.mark.parametrize("name", ["mha", "proto", "resnet18"])
def test_written_pth_reimports_in_the_port_and_in_jax(name, tmp_path):
    """save_reference_checkpoint's file: the JAX layout's keys; strict
    into a fresh port model (every tensor equal); through the JAX
    package's convert_tbn_checkpoint, the bridge's trees of the model."""
    cfg, model, jspec = _model(name)
    path = str(tmp_path / "ref.pth")
    convert_back.save_reference_checkpoint(path, model, model.spec, epoch=4,
                                           train_loss_hist=[{"total": 1.0}])
    data = torch.load(path, weights_only=True)
    assert sorted(data) == ["epoch", "model", "optimizer", "train_loss", "validation_accuracy",
                            "validation_loss"]
    assert data["epoch"] == 4 and data["optimizer"] == {}
    fresh = build_model(cfg, get_modality(cfg), device="cpu", seed=99)
    left_out = checkpoint.load_weights(fresh, checkpoint.read_state_dict(path), path)
    assert left_out == {"not_in_file": [], "not_in_model": []}
    own = model.state_dict()
    assert all(torch.equal(v, own[k]) for k, v in fresh.state_dict().items())
    params, stats = convert_tbn_checkpoint(load_torch_file(path), arch=jspec.arch)
    want = state_dict_to_jax(own)
    assert jax.tree.all(jax.tree.map(np.array_equal, params, want["params"]))
    assert jax.tree.all(jax.tree.map(np.array_equal, stats, want["batch_stats"]))


def test_cli_from_a_port_training_checkpoint(tmp_path):
    """main: test.pre_trained = the port's .pth training checkpoint ->
    the reference layout, with the run's epoch and histories; the port-only
    generator, step and optimizer state are not written."""
    over = SMALL + ["data.flow.enable=false"]
    cfg = load_config(overrides=over)
    model = port_model(cfg, seed=5)
    stem = str(tmp_path / "run" / "tbn")
    checkpoint.save_checkpoint(stem, create_train_state(cfg, model), epoch=2,
                               train_loss_hist=[{"total": 2.5}, {"total": 2.0}],
                               val_loss_hist=[{"total": 2.7}, {"total": 2.4}])
    out = str(tmp_path / "ref.pth")
    convert_back.main(["--output", out, f"test.pre_trained={stem}.pth"] + over)
    data = torch.load(out, weights_only=True)
    assert "generator" not in data and "step" not in data and data["optimizer"] == {}
    assert data["epoch"] == 2 and data["train_loss"] == [{"total": 2.5}, {"total": 2.0}]
    assert data["validation_loss"] == [{"total": 2.7}, {"total": 2.4}]
    _assert_state_dicts_equal(data["model"],
                              convert_back.export_tbn_state_dict(model, model.spec))


def test_cli_refuses_an_orbax_directory_and_a_missing_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="Orbax"):
        convert_back.main(["--output", str(tmp_path / "x.pth"),
                           f"test.pre_trained={tmp_path}"] + SMALL)
    with pytest.raises(SystemExit):
        convert_back.main(["--output", str(tmp_path / "x.pth")] + SMALL)


# ------------------------------------------------------------- convert_cli


def _vgg11_state_dict(batch_norm: bool, rng):
    """torchvision VGG-11 keys at small widths (the converters read the key
    layout and transpose; they do not check widths)."""
    sd, idx, cin = {}, 0, 3
    for item in (8, "M", 8, "M", 8, 8, "M", 8, 8, "M", 8, 8, "M"):
        if item == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = rng.standard_normal((item, cin, 3, 3))
        sd[f"features.{idx}.bias"] = rng.standard_normal(item)
        if batch_norm:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                sd[f"features.{idx + 1}.{leaf}"] = rng.random(item) + 0.5
            sd[f"features.{idx + 1}.num_batches_tracked"] = np.zeros((), np.int64)
        idx, cin = idx + (3 if batch_norm else 2), item
    for i, (o, n) in ((0, (16, 8 * 49)), (3, (16, 16)), (6, (10, 16))):
        sd[f"classifier.{i}.weight"] = rng.standard_normal((o, n))
        sd[f"classifier.{i}.bias"] = rng.standard_normal(o)
    return {k: torch.from_numpy(np.asarray(v, np.float32) if v.dtype != np.int64 else v)
            for k, v in sd.items()}


def _narrow(state_dict, cap=6):
    """Each tensor cut to its first ``cap`` entries along every axis but a
    conv kernel's spatial ones: the key layout and the values of a model,
    at a size that writes fast (the converters check no widths)."""
    out = {}
    for key, value in state_dict.items():
        cut = tuple(slice(0, cap) if value.dim() < 4 or axis < 2 else slice(None)
                    for axis in range(value.dim()))
        out[key] = value[cut].clone()
    return out


def _tower_files(directory):
    """{name: (path, --kind, extra args)} of synthetic .pth inputs."""
    rng = np.random.default_rng(7)
    files = {}
    _, model, _ = _model("mha")
    sd = _narrow(model.state_dict())
    tower = {k[len("Base_Flow."):]: v for k, v in sd.items() if k.startswith("Base_Flow.")}
    tower["last_linear.weight"] = torch.randn(4, 6)
    tower["last_linear.bias"] = torch.randn(4)
    _, resnet, _ = _model("resnet18")
    rsd = _narrow(resnet.state_dict())
    rtower = {k[len("Base_RGB.model."):]: v for k, v in rsd.items()
              if k.startswith("Base_RGB.model.")}
    rtower["fc.weight"], rtower["fc.bias"] = torch.randn(4, 6), torch.randn(4)
    inputs = {
        "bninception": (tower, "bninception", []),
        "bninception_in1": (tower, "bninception", ["--in-channels", "1"]),
        "bninception_in3": (tower, "bninception", ["--in-channels", "3"]),
        "resnet": (rtower, "resnet", []),
        "vgg11": (_vgg11_state_dict(False, rng), "vgg", ["--vgg-type", "11"]),
        "vgg11_bn": (_vgg11_state_dict(True, rng), "vgg", ["--vgg-type", "11_bn"]),
        "tbn": ({"model": sd}, "tbn", []),
        "tbn_resnet": (rsd, "tbn", ["--arch", "resnet"]),
    }
    for name, (sd, kind, extra) in inputs.items():
        path = os.path.join(directory, f"{name}.pth")
        torch.save(sd, path)
        files[name] = (path, kind, extra)
    return files


def test_npz_equals_the_jax_cli_for_every_kind(tmp_path):
    """The same synthetic .pth through both CLIs: the same arrays under the
    same names, bit for bit, float32; load_npz reads both back alike."""
    for name, (path, kind, extra) in _tower_files(str(tmp_path)).items():
        got, want = str(tmp_path / f"{name}.port.npz"), str(tmp_path / f"{name}.jax.npz")
        args = ["--input", path, "--kind", kind] + extra
        convert_cli.main(args + ["--output", got])
        jax_convert_cli.main(args + ["--output", want])
        with np.load(got) as g, np.load(want) as w:
            assert sorted(g.files) == sorted(w.files), name
            for key in w.files:
                assert g[key].dtype == w[key].dtype == np.float32, (name, key)
                assert np.array_equal(g[key], w[key]), (name, key)
        port_trees, jax_trees = convert_cli.load_npz(got), jax_convert_cli.load_npz(want)
        assert jax.tree.all(jax.tree.map(np.array_equal, port_trees, jax_trees)), name
    params, _ = convert_cli.load_npz(str(tmp_path / "bninception_in1.port.npz"))
    assert params["conv1_7x7_s2"]["conv"]["kernel"].shape == (7, 7, 1, 6)


def test_npz_tower_loads_into_the_port_tower(tmp_path):
    """convert_cli's BN-Inception .npz back through models/convert's
    load_npz_tower: the tower's own state dict, bit for bit."""
    _, model, _ = _model("mha")
    tower = {k[len("Base_RGB."):]: v for k, v in model.state_dict().items()
             if k.startswith("Base_RGB.") and not k.endswith("num_batches_tracked")}
    torch.save(tower, tmp_path / "t.pth")
    convert_cli.main(["--input", str(tmp_path / "t.pth"), "--kind", "bninception",
                      "--output", str(tmp_path / "t.npz")])
    from attention_based_tbn_tpu_torch.models.convert import load_npz_tower

    back = load_npz_tower(str(tmp_path / "t.npz"))
    assert set(back) == set(tower) and all(torch.equal(back[k], tower[k]) for k in tower)


def test_convert_cli_refuses_a_family_its_keys_contradict(tmp_path):
    files = _tower_files(str(tmp_path))
    with pytest.raises(ValueError, match="--arch"):
        convert_cli.main(["--input", files["tbn"][0], "--kind", "tbn", "--arch", "resnet",
                          "--output", str(tmp_path / "x.npz")])
    with pytest.raises(ValueError, match="--vgg-type"):
        convert_cli.main(["--input", files["vgg11"][0], "--kind", "vgg", "--vgg-type", "16",
                          "--output", str(tmp_path / "x.npz")])
