"""The port's whole TBN eval forward against the JAX package's
``TBNModel.apply(train=False)`` on the same weights and inputs: 64-px
crops, 2 segments, 1.279 s audio (attention window 8), fp32, uint8 video.

Tolerance: logits rtol 1e-4 / atol 5e-4, attention weights atol 5e-5 —
fp32 summation order through ~60 conv layers per tower.
"""

import pytest

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread,
    assert_outputs_match,
    configs,
    jax_forward,
    make_batch,
    port_forward,
    port_model,
)

CASES = {
    "mha_trimodal": [],
    "mha_rgb_audio": ["data.flow.enable=false"],
    "unimodal": ["model.attention.type=unimodal", "data.flow.enable=false"],
    "proto": ["model.attention.type=proto", "data.flow.enable=false"],
    "use_fixed": ["model.attention.use_fixed=true", "data.flow.enable=false"],
    "attention_off": ["model.attention.enable=false"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches_jax(case):
    cfg, jcfg = configs(CASES[case])
    model = port_model(cfg)
    batch = make_batch(cfg)
    got = port_forward(model, batch)
    want = jax_forward(jcfg, model.state_dict(), batch)
    assert_outputs_match(got, want)
    assert got["verb"].shape == (2, 125) and got["noun"].shape == (2, 352)
    if case.startswith("mha"):
        assert got["weights"].shape == (4, 1, 8)
    elif case in ("unimodal", "proto"):
        assert got["weights"].shape == (4, 8)
    else:
        assert "weights" not in got
