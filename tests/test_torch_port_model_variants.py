"""Eval-forward options of the port against the JAX package: the audio
stem, fast consensus, MHA without the PE block, the log-mel spectrogram,
10-crop row tiling, and the bf16 compute dtype.

Tolerance: as tests/test_torch_port_model.py (fp32 logits rtol 1e-4 /
atol 5e-4, weights atol 5e-5); bf16 against the fp32 forward uses the
repo's bf16 drift bound, logit rel-RMSE < 0.04 (tests/test_bf16_drift.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from attention_based_tbn_tpu.models.tbn import tile_crop_rows as jax_tile_crop_rows
from attention_based_tbn_tpu_torch.models.tbn import TBNModel, TBNSpec, tile_crop_rows
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
    "audio_stem_fast_consensus": ["data.flow.enable=false", "model.bninception.audio_stem=true",
                                  "tpu.fast_consensus=true"],
    "mha_without_pe": ["data.flow.enable=false", "model.attention.use_pe=false"],
    "logms": ["data.flow.enable=false", "data.audio.spec_type=logms"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_options_match_jax(case):
    cfg, jcfg = configs(CASES[case])
    model = port_model(cfg)
    batch = make_batch(cfg, seed=3)
    assert_outputs_match(port_forward(model, batch), jax_forward(jcfg, model.state_dict(), batch))


def test_ten_crop_matches_jax():
    """Visual streams carry 10 crop rows per segment; each crop row queries
    its own segment's audio window."""
    cfg, jcfg = configs(["data.flow.enable=false"])
    model = port_model(cfg)
    batch = make_batch(cfg, b=1, seed=4, crops=10)
    got = port_forward(model, batch)
    assert got["weights"].shape == (20, 1, 8)
    assert_outputs_match(got, jax_forward(jcfg, model.state_dict(), batch))


@pytest.mark.parametrize("reps", [10, 3])
def test_tile_crop_rows_matches_jax(reps):
    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(6, 4, 5)  # b=2, 3 segments
    want = np.asarray(jax_tile_crop_rows(jnp.asarray(x), 2, reps))
    np.testing.assert_array_equal(tile_crop_rows(torch.from_numpy(x), 2, reps).numpy(), want)


def test_bf16_forward_stays_within_the_drift_bound():
    cfg, _ = configs(["data.flow.enable=false"])
    model = port_model(cfg)
    batch = make_batch(cfg, b=4, seed=5)
    fp32 = port_forward(model, batch)
    model16 = TBNModel(TBNSpec(**{**model.spec.__dict__, "compute_dtype": "bfloat16"})).eval()
    model16.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        out16 = model16({k: torch.from_numpy(v) for k, v in batch.items()})
    assert out16["verb"].dtype == torch.float32 and out16["weights"].dtype == torch.bfloat16
    for head in ("verb", "noun"):
        a, b = fp32[head], out16[head].numpy()
        rel = np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(a**2))
        assert 0 < rel < 0.04, (head, rel)


def test_training_forward_is_refused():
    """The training forward draws dropout and gumbel noise from an explicit
    generator only: without one it is refused, with one it runs."""
    cfg, _ = configs(["data.flow.enable=false"])
    model = port_model(cfg).train()
    with pytest.raises(ValueError, match="Generator"):
        port_forward(model, make_batch(cfg))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    with torch.no_grad():
        out = model(batch, generator=torch.Generator().manual_seed(0))
    assert out["verb"].shape == (2, 125) and torch.isfinite(out["noun"]).all()


def test_spec_validation():
    with pytest.raises(ValueError, match="not ported"):
        TBNSpec(arch="resnet").validate()
    with pytest.raises(ValueError, match="visual query"):
        TBNSpec(modality=("Audio",)).validate()
    with pytest.raises(ValueError, match="Unknown attention"):
        TBNSpec(attention_type="lstm").validate()
    with pytest.raises(ValueError, match="compute dtype"):
        TBNSpec(compute_dtype="float16").validate()
