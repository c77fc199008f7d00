"""The port's weight bridge (models/bridge.py) against the JAX package's
exporter ``models/convert_back.export_tbn_state_dict``: same keys, same
values (exactly), a strict load into the port, and exact round trips.

The JAX variables have the JAX model's own tree (``TBNModel.init`` traced
abstractly) filled with seeded random values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from attention_based_tbn_tpu.models.convert_back import export_tbn_state_dict
from attention_based_tbn_tpu.models.tbn import TBNModel as JaxTBNModel
from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu_torch.models.bridge import (
    jax_to_state_dict,
    load_jax_variables,
    state_dict_to_jax,
)
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.models.tbn import TBNModel
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    configs,
    make_batch,
    one_torch_thread,
)

CASES = {
    "mha_trimodal_audio_stem": ["model.bninception.audio_stem=true"],
    "unimodal": ["model.attention.type=unimodal", "data.flow.enable=false"],
    "proto": ["model.attention.type=proto", "data.flow.enable=false"],
    "use_fixed": ["model.attention.use_fixed=true", "data.flow.enable=false"],
}


def jax_variables(jcfg, seed=0):
    """Random numpy values on the JAX model's variable tree."""
    spec = JaxTBNSpec.from_config(jcfg, get_modality(jcfg))
    batch = {k: jnp.asarray(v) for k, v in make_batch(jcfg, b=1).items()}
    shapes = jax.eval_shape(
        lambda: JaxTBNModel(spec).init(jax.random.key(0), batch, train=False)
    )
    rng = np.random.default_rng(seed)
    return spec, jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), dict(shapes)
    )


def flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bridge_matches_jax_exporter_and_round_trips(case):
    cfg, jcfg = configs(CASES[case])
    jspec, variables = jax_variables(jcfg)
    model = build_model(cfg, get_modality(cfg), device="cpu")

    ours = jax_to_state_dict(variables, model.spec)
    theirs = export_tbn_state_dict(variables, jspec)
    assert set(ours) == set(theirs) == set(model.state_dict())
    for key, value in theirs.items():
        assert ours[key].dtype == value.dtype and ours[key].shape == value.shape, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)

    load_jax_variables(model, variables)  # strict=True
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), ours[key], err_msg=key)

    # port -> JAX tree -> port, and the JAX tree itself, exactly
    back = state_dict_to_jax(model.state_dict())
    back_leaves = dict(flatten(back))
    assert back_leaves.keys() == dict(flatten(variables)).keys()
    for path, value in flatten(variables):
        np.testing.assert_array_equal(back_leaves[path], value, err_msg=str(path))
    again = TBNModel(model.spec)  # uninitialized parameters
    load_jax_variables(again, back)
    again_sd = again.state_dict()
    for key, value in model.state_dict().items():
        torch.testing.assert_close(again_sd[key], value, rtol=0, atol=0)


def test_seeded_init_is_deterministic_and_seed_dependent():
    cfg, _ = configs(["data.flow.enable=false"])
    a = build_model(cfg, get_modality(cfg), device="cpu", seed=3).state_dict()
    b = build_model(cfg, get_modality(cfg), device="cpu", seed=3).state_dict()
    c = build_model(cfg, get_modality(cfg), device="cpu", seed=4).state_dict()
    key = "Base_RGB.conv1_7x7_s2.weight"
    torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    assert not torch.equal(a[key], c[key])
    # the JAX package's init statistics: fan-out truncated normal, std
    # sqrt(2 / fan_out) before truncation at 2 std
    w = a["Base_RGB.inception_5b_3x3.weight"]
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    assert abs(w.std().item() / np.sqrt(2.0 / fan_out) - 1) < 0.05
    assert a["classifier.verb.weight"].std().item() == pytest.approx(1e-3, rel=0.05)


def test_unported_arch_is_refused():
    _, jcfg = configs(["data.flow.enable=false"])
    jspec, variables = jax_variables(jcfg)
    with pytest.raises(ValueError, match="not ported"):
        jax_to_state_dict(variables, type("Spec", (), {"arch": "resnet"})())
