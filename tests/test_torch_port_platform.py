"""The port's platform keys (utils/platform.py) and the tpu.* keys it
accepts as no-ops or documented equivalents: ``device_for``, the
``--device`` / ``tpu.platform`` rule of the export and serve CLIs,
``tpu.host_devices`` and ``tpu.compile_cache`` (one log line each, no
refusal), and ``tpu.pool_proj_conv`` / ``tpu.direct_stem``, whose logits
match the JAX package's under the same overrides at fp32."""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

from attention_based_tbn_tpu_torch import main as port_main
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.models.tbn import TBNSpec
from attention_based_tbn_tpu_torch.tools import export, serve
from attention_based_tbn_tpu_torch.utils.platform import cli_device, device_for, note_unused_keys

from torch_port_helpers import (  # noqa: F401
    SMALL, assert_outputs_match, configs, jax_forward, make_batch, one_torch_thread, port_forward,
    port_model,
)

NO_OP_KEYS = ["tpu.host_devices=8", "tpu.compile_cache=/tmp/xla_cache", "tpu.direct_stem=true",
              "tpu.pool_proj_conv=true"]


@pytest.mark.parametrize("platform,device", [("", "cuda"), ("gpu", "cuda"), ("cuda", "cuda"),
                                             ("CPU", "cpu"), ("cpu", "cpu")])
def test_device_for(platform, device):
    assert device_for(load_config(overrides=[f"tpu.platform={platform}"])) == device
    assert port_main.device_for is device_for  # main's, moved here


def test_device_for_refuses_other_platforms():
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        device_for(load_config(overrides=["tpu.platform=tpu"]))


@pytest.mark.parametrize("flag,platform,want", [
    (None, "", "cuda"), (None, "cpu", "cpu"), ("cpu", "", "cpu"), ("cpu", "cpu", "cpu"),
    ("cuda:1", "gpu", "cuda:1"), ("cuda", "cuda", "cuda"),
])
def test_cli_device(flag, platform, want):
    assert cli_device(load_config(overrides=[f"tpu.platform={platform}"]), flag) == want


@pytest.mark.parametrize("flag,platform", [("cpu", "cuda"), ("cuda", "cpu"), ("cuda:0", "cpu")])
@pytest.mark.parametrize("cli", ["export", "serve"])
def test_device_and_platform_clash_is_refused(cli, flag, platform):
    """--device and tpu.platform naming different devices: both CLIs raise
    before building anything."""
    argv = ["--device", flag, f"tpu.platform={platform}"] + SMALL
    with pytest.raises(ValueError, match="name different devices"):
        (export.main if cli == "export" else serve.main)(argv)


def test_serve_runs_on_the_cpu_for_tpu_platform_cpu(capsys):
    """tpu.platform=cpu alone puts the served model on the CPU, as main."""
    serve.main(["tpu.platform=cpu", "--bench", "1", "data.flow.enable=false"] + SMALL)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["platform"] == "cpu" and line["device"] == "cpu"


def test_no_op_keys_parse_and_log_one_line_each(caplog):
    cfg = load_config(overrides=NO_OP_KEYS)
    spec = TBNSpec.from_config(cfg, ["RGB", "Flow", "Audio"])
    assert spec.direct_stem and spec.pool_proj_conv
    assert not TBNSpec.from_config(load_config(), ["RGB"]).direct_stem
    with caplog.at_level(logging.INFO):
        lines = note_unused_keys(cfg)
    assert len(lines) == 2 and "tpu.host_devices=8 does nothing" in lines[0]
    assert "tpu.compile_cache=/tmp/xla_cache does nothing" in lines[1]
    assert [r.getMessage() for r in caplog.records] == lines
    assert note_unused_keys(load_config()) == []


def test_main_logs_the_no_op_keys_and_runs(tmp_path):
    """main with the JAX package's platform lines (tpu.platform=cpu
    tpu.host_devices=8 tpu.compile_cache=...): accepted, one run-log line
    each, and the run goes on."""
    port_main.main(["tpu.platform=cpu", "tpu.host_devices=8",
                    f"tpu.compile_cache={tmp_path}/cache", "train.enable=false",
                    "test.enable=false", f"out_dir={tmp_path}", "exp_name=noop"])
    logs = glob.glob(os.path.join(tmp_path, "log", "noop", "*", "*.log"))
    text = open(logs[0]).read()
    assert "tpu.host_devices=8 does nothing in the port" in text
    assert "tpu.compile_cache=" in text and "Device: cpu" in text
    assert not os.path.exists(tmp_path / "cache")


@pytest.mark.parametrize("over", [
    ["tpu.pool_proj_conv=true", "tpu.merge_inception=false"],
    ["tpu.direct_stem=true"],
], ids=["pool_proj_conv", "direct_stem"])
def test_equivalent_keys_match_jax_logits(over):
    """The JAX package runs another lowering under these keys (the avg-pool
    + 1x1 projection as one 3x3 conv of the kernel / 9; the plain stem conv
    in place of its packed rewrite); the port's forward, the same math,
    matches it at fp32 and is bit-equal to its own forward without them."""
    cfg, jcfg = configs(["data.flow.enable=false"] + over)
    plain_cfg, _ = configs(["data.flow.enable=false"])
    model = port_model(cfg)
    batch = make_batch(cfg, b=2, seed=4)
    got = port_forward(model, batch)
    assert_outputs_match(got, jax_forward(jcfg, model.state_dict(), batch))
    plain = port_model(plain_cfg)
    plain.load_state_dict(model.state_dict())
    assert all(np.array_equal(v, got[k]) for k, v in port_forward(plain, batch).items())
    assert torch.equal(plain.state_dict()["pe.1.weight"], model.state_dict()["pe.1.weight"])
