"""The port's int8 and bf16 serving bundles on the CPU, against the JAX
package's serving dtypes (tools/export.py).

* int8: the JAX test_export_int8_serving_mode config (RGB, no attention,
  5 verbs / 7 nouns, 64-px crops, 2 segments, fp32 compute) and its
  weights (JAX init, key 0), restored from a ``.pth`` by the export CLI.
  The bundle equals JAX's ``model.apply(dequantize(quantize_int8(v)))``
  within ``assert_outputs_match`` and holds that test's bound against the
  fp32 model: max |diff| < 0.05 std + 0.05, the same argmax.
* bf16: RGB + Audio, PE + MHA (the kernels cast, BatchNorm fp32), within
  rel-RMSE 0.04 (the repo's bf16 drift bound) of JAX's forward on the
  same bf16-cast variables: both fold the same stored bf16 kernels.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attention_based_tbn_tpu.models.tbn import TBNModel as JaxTBNModel
from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu.tools import export as jax_export
from attention_based_tbn_tpu_torch.models.bridge import jax_to_state_dict, state_dict_to_jax
from attention_based_tbn_tpu_torch.tools import export
from attention_based_tbn_tpu_torch.tools.serve import BundleModel
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_outputs_match,
    configs,
    make_batch,
    one_torch_thread,
    port_model,
)

INT8_OVERRIDES = ["model.attention.enable=False", "model.pretrained=False",
                  "data.audio.audio_length=1.279", "data.test_crop_size=64",
                  "test.num_segments=2", "model.num_classes={verb: 5, noun: 7}",
                  "tpu.compute_dtype=float32", "data.flow.enable=false",
                  "data.audio.enable=false"]
BF16_DRIFT = 0.04


def _jax_apply(jcfg, variables, batch):
    model = JaxTBNModel(JaxTBNSpec.from_config(jcfg, get_modality(jcfg)))
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _rel_rmse(got, want):
    return float(np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)))


@pytest.fixture(scope="module")
def int8_case(tmp_path_factory):
    """JAX's variables (init key 0) saved as a reference .pth, exported as
    an int8 bundle through the CLI (``test.pre_trained``)."""
    from attention_based_tbn_tpu.config import load_config as jax_load_config

    tmp = tmp_path_factory.mktemp("int8")
    jcfg = jax_load_config(overrides=INT8_OVERRIDES)
    batch = {"RGB": np.random.default_rng(0).integers(0, 255, (2, 2, 64, 64, 3)).astype(
        np.uint8)}
    model = JaxTBNModel(JaxTBNSpec.from_config(jcfg, ["RGB"]))
    variables = jax.jit(lambda r, b: model.init(r, b, train=False))(
        {"params": jax.random.key(0)}, {k: jnp.asarray(v) for k, v in batch.items()})
    spec = JaxTBNSpec.from_config(jcfg, ["RGB"])
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in jax_to_state_dict(jax.tree.map(np.asarray, variables), spec).items()}
    pth = str(tmp / "weights.pth")
    torch.save({"model": sd}, pth)
    export.main(["--device", "cpu", *INT8_OVERRIDES, f"out_dir={tmp}", f"test.pre_trained={pth}",
                 "tpu.export_batch=2", "tpu.serving_dtype=int8"])
    return jcfg, variables, sd, batch, str(tmp / "export")


def test_int8_params_are_stored_as_int8(int8_case):
    _, _, sd, _, bundle_dir = int8_case
    stored = torch.load(os.path.join(bundle_dir, "params.pt"), weights_only=True)
    quantized = {k for k, v in stored.items() if isinstance(v, dict)}
    assert quantized == export.kernel_keys(sd) and len(quantized) == 71  # 69 convs, 2 heads
    want = export.quantize_int8(sd)
    for key in quantized:
        assert stored[key]["q"].dtype == torch.int8, key
        torch.testing.assert_close(stored[key]["q"], want[key]["q"], rtol=0, atol=0)
        torch.testing.assert_close(stored[key]["scale"], want[key]["scale"], rtol=0, atol=0)
    manifest = json.load(open(os.path.join(bundle_dir, "manifest.json")))
    assert manifest["serving_dtype"] == "int8"
    assert manifest["quantization"] == {  # JAX's text (tools/export.py:284-291)
        "scheme": "weight-only symmetric per-output-channel", "bits": 8,
        "dequantize": "in-graph (module inputs are the int8 tree)"}


def test_int8_bundle_matches_jax_dequantized_forward(int8_case):
    jcfg, variables, _, batch, bundle_dir = int8_case
    want = _jax_apply(jcfg, jax_export.dequantize(jax_export.quantize_int8(variables)), batch)
    got = BundleModel(bundle_dir, device="cpu").predict(batch)
    assert_outputs_match(got, want)


def test_int8_bundle_holds_the_jax_bound_against_fp32(int8_case):
    """test_export_int8_serving_mode's bound, on the bundle: per-channel
    symmetric int8 keeps |dw| <= max|w| / 254."""
    jcfg, variables, _, batch, bundle_dir = int8_case
    ref = _jax_apply(jcfg, variables, batch)
    got = BundleModel(bundle_dir, device="cpu").predict(batch)
    for head in ("verb", "noun"):
        r, g = ref[head], got[head]
        assert np.max(np.abs(r - g)) < 0.05 * (np.std(r) + 1e-6) + 0.05
        np.testing.assert_array_equal(r.argmax(-1), g.argmax(-1))


@pytest.fixture(scope="module")
def bf16_case(tmp_path_factory):
    cfg, jcfg = configs(["data.flow.enable=false", "model.attention.type=mha"])
    model = port_model(cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    out = str(tmp_path_factory.mktemp("bf16"))
    export.export_inference(cfg, get_modality(cfg), state=sd, out_dir=out, batch_size=2,
                            serving_dtype="bfloat16", device="cpu")
    return cfg, jcfg, sd, out


def test_bf16_bundle_casts_only_the_kernels(bf16_case):
    _, _, sd, out = bf16_case
    stored = torch.load(os.path.join(out, "params.pt"), weights_only=True)
    cast = {k for k, v in stored.items() if v.dtype == torch.bfloat16}
    assert cast == export.kernel_keys(sd)
    for key, value in stored.items():
        want = sd[key].to(torch.bfloat16) if key in cast else sd[key]
        torch.testing.assert_close(value, want, rtol=0, atol=0)
    assert json.load(open(os.path.join(out, "manifest.json")))["serving_dtype"] == "bfloat16"


def test_bf16_bundle_matches_jax_bf16_cast_forward(bf16_case):
    """JAX's bf16 serving mode casts the kernel leaves and applies the model
    (tools/export.py:178-193); the port's bundle folds the same stored bf16
    kernels."""
    cfg, jcfg, sd, out = bf16_case
    batch = make_batch(cfg, b=2, seed=7)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(x, jnp.bfloat16)
        if getattr(path[-1], "key", None) == "kernel" else jnp.asarray(x),
        state_dict_to_jax(sd))
    want = _jax_apply(jcfg, variables, batch)
    got = BundleModel(out, device="cpu").predict(batch)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape and np.isfinite(got[key]).all()
        assert _rel_rmse(got[key], want[key]) < BF16_DRIFT, key
