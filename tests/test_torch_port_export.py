"""The port's serving export (tools/export.py) on the CPU, against the JAX
package's tools/export.py: int8 quantization bit for bit, the fp32 bundle
against the port's eager forward (exactly) and JAX's forward
(``assert_outputs_match``), the manifest against JAX's, the verified row
multipliers, the caches that must not keep a traced tensor, and the
kernels' ``tbn::`` ops as an export sees them (fake implementations on
fake CUDA tensors; no CPU kernel, so no fallback).

Config: RGB + Audio, PE + MHA, 64-px crops, 2 segments, 1.279 s audio,
fp32, BatchNorm randomized; the bundle at batch 2 with a bucket of 1.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
from attention_based_tbn_tpu.tools import export as jax_export
from attention_based_tbn_tpu_torch.models.bridge import (
    jax_to_state_dict,
    kernel_keys,
    state_dict_to_jax,
)
from attention_based_tbn_tpu_torch.ops import kernels
from attention_based_tbn_tpu_torch.parallel.train_step import TrainState
from attention_based_tbn_tpu_torch.tools import export
from attention_based_tbn_tpu_torch.tools.serve import BundleModel
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    assert_outputs_match,
    configs,
    jax_forward,
    make_batch,
    one_torch_thread,
    port_forward,
    port_model,
)

OVERRIDES = ["data.flow.enable=false", "model.attention.type=mha"]


@pytest.fixture(scope="module")
def small():
    cfg, jcfg = configs(OVERRIDES)
    model = port_model(cfg)
    return cfg, jcfg, model, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def fp32_bundle(small, tmp_path_factory):
    """The bundle of the eager model itself, with eager forwards of that
    model just before and just after the export."""
    cfg, _, model, _ = small
    out = str(tmp_path_factory.mktemp("fp32"))
    batch = make_batch(cfg, b=2, seed=5)
    before = port_forward(model, batch)
    paths = export.export_inference(cfg, get_modality(cfg),
                                    state=TrainState(model=model, optimizer=None, generator=None),
                                    out_dir=out, batch_size=2, batch_buckets=[1], device="cpu")
    with torch.no_grad():
        after = model({k: torch.from_numpy(v) for k, v in batch.items()})
    return paths, batch, before, after


# ------------------------------------------------------------- int8, bridge


def _jax_kernel_image(variables, spec):
    """Port keys whose tensors are images of JAX ``kernel`` leaves: ones on
    the kernel leaves, zeros elsewhere, through the bridge."""
    marked = jax.tree_util.tree_map_with_path(
        lambda path, x: np.ones_like(x) if getattr(path[-1], "key", None) == "kernel"
        else np.zeros_like(x), variables)
    sd = jax_to_state_dict(marked, spec)
    return {k for k, v in sd.items() if v.size and np.all(np.asarray(v) == 1)}


def test_quantize_int8_is_bit_equal_to_jax(small):
    """q and scale of every kernel equal JAX's quantize_int8 on the bridged
    variables bit for bit (both round half to even), and the quantized port
    keys are exactly the image of JAX's kernel leaves."""
    _, jcfg, _, sd = small
    variables = state_dict_to_jax(sd)
    spec = JaxTBNSpec.from_config(jcfg, get_modality(jcfg))
    qstate = export.quantize_int8(sd)
    quantized = {k for k, v in qstate.items() if isinstance(v, dict)}
    assert quantized == kernel_keys(sd) == _jax_kernel_image(variables, spec)
    assert len(quantized) == 144  # 2 x 69 convolutions, pe, 2 MHA, fusion, 2 heads

    jq = jax_export.quantize_int8(jax.tree.map(jnp.asarray, variables))
    # the port's q and its scale broadcast to the kernel's shape, carried to
    # the JAX layout by the bridge
    q_tree = state_dict_to_jax({k: v["q"].float() if k in quantized else torch.zeros(v.shape)
                                for k, v in qstate.items()})["params"]
    s_tree = state_dict_to_jax({k: v["scale"].expand(v["q"].shape) if k in quantized
                                else torch.zeros(v.shape) for k, v in qstate.items()})["params"]
    leaves = jax.tree_util.tree_flatten_with_path(
        jq["params"], is_leaf=lambda x: isinstance(x, dict) and set(x) == {"q", "scale"})[0]
    checked = 0
    for path, leaf in leaves:
        if not isinstance(leaf, dict):
            continue
        q_port, s_port = q_tree, s_tree
        for p in path:  # ends at the "kernel" key
            q_port, s_port = q_port[p.key], s_port[p.key]
        assert path[-1].key == "kernel" and np.asarray(leaf["q"]).dtype == np.int8
        np.testing.assert_array_equal(q_port, np.asarray(leaf["q"], np.float32))
        np.testing.assert_array_equal(
            s_port, np.broadcast_to(np.asarray(leaf["scale"]), leaf["q"].shape))
        checked += 1
    assert checked == 146  # the in-projection is three JAX kernels


def test_dequantize_round_trips_within_half_a_scale(small):
    """|q * scale - w| <= scale / 2, plus the float32 roundings of w / scale
    and of q * scale: each under 2^-24 of a value up to 127 scales."""
    _, _, _, sd = small
    qstate = export.quantize_int8(sd)
    dense = export.dequantize(qstate)
    assert set(dense) == set(sd)
    for key, v in qstate.items():
        if isinstance(v, dict):
            assert v["q"].dtype == torch.int8 and v["scale"].dtype == torch.float32
            assert v["scale"].shape == (v["q"].shape[0],) + (1,) * (v["q"].dim() - 1)
            err = (dense[key] - sd[key]).abs()
            assert bool((err <= v["scale"] * (0.5 + 2 * 127 * 2.0 ** -24)).all()), key
        else:
            assert dense[key] is sd[key]


def test_zero_channel_gets_unit_scale():
    w = torch.randn(3, 4, 1, 1)
    w[1] = 0
    q = export.quantize_int8({"Base_RGB.conv2_3x3_reduce.weight": w})
    entry = q["Base_RGB.conv2_3x3_reduce.weight"]
    assert entry["scale"][1].item() == 1.0 and not entry["q"][1].any()
    assert entry["q"].abs().max().item() == 127


# -------------------------------------------------------- the fp32 bundle


def test_eager_forward_after_export_is_real_and_unchanged(fp32_bundle):
    """An export traces the model's caches (fold, casts, the spectrogram's
    basis) on fake tensors; none of them may keep one, or the next eager
    forward returns fake tensors."""
    _, _, before, after = fp32_bundle
    for key, value in after.items():
        assert type(value) is torch.Tensor, (key, type(value))
        np.testing.assert_array_equal(value.float().numpy(), before[key], err_msg=key)


def test_fp32_bundle_equals_eager_exactly(fp32_bundle, small):
    paths, batch, before, _ = fp32_bundle
    bundle = BundleModel(os.path.dirname(paths["manifest"]), device="cpu")
    got = bundle.predict(batch)
    assert bundle.last_bucket == 2
    for key in before:
        np.testing.assert_array_equal(got[key], before[key], err_msg=key)
    one = {k: v[:1] for k, v in batch.items()}
    got = bundle.predict(one)
    assert bundle.last_bucket == 1
    want = port_forward(small[2], one)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_fp32_bundle_matches_jax(fp32_bundle, small):
    paths, batch, _, _ = fp32_bundle
    _, jcfg, _, sd = small
    bundle = BundleModel(os.path.dirname(paths["manifest"]), device="cpu")
    assert_outputs_match(bundle.predict(batch), jax_forward(jcfg, sd, batch))


def test_manifest_matches_jax_export(fp32_bundle, small, tmp_path):
    """Every field the JAX manifest shares with the port's holds the same
    value for the same config, buckets and segments."""
    paths, _, _, _ = fp32_bundle
    _, jcfg, _, _ = small
    jpaths = jax_export.export_inference(jcfg, get_modality(jcfg), out_dir=str(tmp_path),
                                         batch_size=2, num_segments=2, batch_buckets=[1])
    ours = json.load(open(paths["manifest"]))
    theirs = json.load(open(jpaths["manifest"]))
    for field in ("modality", "inputs", "outputs", "output_names", "output_row_multipliers",
                  "num_segments", "batch_size", "serving_dtype", "quantization", "arch",
                  "attention", "audio"):
        assert ours[field] == theirs[field], field
    assert sorted(ours["batch_buckets"]) == sorted(theirs["batch_buckets"]) == ["1", "2"]
    assert ours["format"] == "torch.export" and ours["torch_version"] == torch.__version__
    assert ours["output_row_multipliers"] == {"noun": 1, "verb": 1, "weights": 2}
    assert ours["param_leaf_count"] == len(small[3])
    for name, digest in ours["program_sha256"].items():
        assert len(digest) == 64 and os.path.exists(os.path.join(os.path.dirname(
            paths["manifest"]), name))
    assert ours["kernel_ops"] == {"module.pt2": {}, "module.b1.pt2": {}}  # CPU: plain versions


def test_programs_hold_no_weights(fp32_bundle):
    """The parameters are the programs' inputs and live in params.pt only:
    a program's constants are the input affines and the spectrogram basis."""
    paths, _, _, _ = fp32_bundle
    program = torch.export.load(paths["module"])
    assert not program.state_dict
    assert sum(t.numel() for t in program.constants.values()) < 400_000
    assert program.example_inputs is None
    params = torch.load(paths["params"], weights_only=True)
    assert os.path.getsize(paths["module"]) < os.path.getsize(paths["params"]) / 4
    assert all(v.dtype == torch.float32 for k, v in params.items()
               if not k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("buckets", [[3], [0], [2, 5]])
def test_bad_bucket_raises(small, tmp_path, buckets):
    cfg = small[0]
    with pytest.raises(ValueError, match="bucket"):
        export.export_inference(cfg, get_modality(cfg), out_dir=str(tmp_path), batch_size=2,
                                batch_buckets=buckets, device="cpu")
    assert not os.listdir(tmp_path)


def test_bad_serving_dtype_raises(small, tmp_path):
    cfg = small[0]
    with pytest.raises(ValueError, match="serving_dtype"):
        export.export_inference(cfg, get_modality(cfg), out_dir=str(tmp_path),
                                serving_dtype="float16", device="cpu")


def test_output_row_multipliers_verified_batch_invariant(small):
    """A global output whose leading dim is a multiple of the batch (always
    at b=1) is declared None, not per row: the multipliers come from shape
    passes at b and b + 1, not from divisibility at b."""
    cfg = small[0]
    n_seg = 2

    def forward(params, batch):
        b = batch["RGB"].shape[0]
        return {
            "verb": torch.zeros((b, 5)),  # per row, k=1
            "weights": torch.zeros((b * n_seg, 4)),  # per row, k=n_seg
            "global_stat": torch.zeros((1, 3)),  # lead 1 divides b=1
            "scalar": torch.zeros(()),  # no leading dim
        }

    mults = export._output_row_multipliers(forward, {}, cfg, ["RGB", "Audio"], 1, n_seg, "cpu")
    assert mults == {"global_stat": None, "scalar": None, "verb": 1, "weights": n_seg}
    assert list(mults) == sorted(mults)  # the programs' flat output order


# ------------------------------------------------------ the kernels as ops

BF16 = torch.bfloat16


def _fake_calls(e):
    """(name, call, expected shape, dtype) of every kernel op, on fake CUDA
    tensors made by ``e``."""
    cl = torch.channels_last
    return [
        ("pe_block", lambda: kernels.pe_block(e(2, 8, 64), e(8, 10), e(64, 74), e(64), e(64),
                                              e(64), 16), (2, 8, 64), torch.float32),
        ("pe_block_bf16", lambda: kernels.pe_block_bf16(
            e(2, 8, 64, dtype=BF16), (e(64, 64, dtype=BF16), e(8, 64)), e(64, dtype=BF16),
            e(64, dtype=BF16), 16), (2, 8, 64), BF16),
        ("mha", lambda: kernels.mha(e(2, 64, dtype=BF16), e(2, 8, 64, dtype=BF16),
                                    e(192, 64, dtype=BF16), e(192, dtype=BF16),
                                    e(64, 64, dtype=BF16), e(64, dtype=BF16), 4)[1],
         (2, 8), BF16),
        ("max_pool", lambda: kernels.ceil_max_pool2d(e(2, 8, 15, 12, memory_format=cl)),
         (2, 8, 7, 6), torch.float32),
        ("max_pool_taps", lambda: kernels._launch_max_pool(e(2, 8, 15, 12), True)[1],
         (2, 8, 7, 6), torch.uint8),
        ("max_pool_backward", lambda: kernels._launch_max_pool_backward(
            e(2, 8, 7, 6, memory_format=cl), e(2, 8, 7, 6, dtype=torch.uint8,
                                                memory_format=cl), (2, 8, 15, 12), True),
         (2, 8, 15, 12), torch.float32),
        ("fused_stem", lambda: kernels.fused_stem(
            e(2, 32, 32, 3, dtype=torch.uint8), e(64, 3, 7, 7, dtype=BF16), e(64), e(3), e(3),
            BF16), (2, 64, 8, 8), BF16),
        ("consensus_heads", lambda: kernels._consensus_heads_op(
            e(2, 3, 512, dtype=BF16), [e(125, 512, dtype=BF16), e(352, 512, dtype=BF16)],
            [e(125, dtype=BF16), e(352, dtype=BF16)]), (2 * 477,), torch.float32),
        ("conv3x3", lambda: kernels.conv3x3(e(2, 5, 6, 16, dtype=BF16), e(8, 16, 3, 3, dtype=BF16),
                                            e(8)), (2, 5, 6, 8), BF16),
    ]


@pytest.mark.parametrize("name", [c[0] for c in _fake_calls(None)])
def test_op_fake_implementation(name):
    """What an export sees of each kernel: the op's output shape, type and
    (for the pools and the stem) channels-last layout from its fake
    implementation, on fake CUDA tensors; no launch counted."""
    kernels.reset_launch_counts()
    with FakeTensorMode():
        def e(*shape, dtype=torch.float32, memory_format=torch.contiguous_format):
            return torch.empty(*shape, dtype=dtype, device="cuda", memory_format=memory_format)

        _, call, shape, dtype = next(c for c in _fake_calls(e) if c[0] == name)
        out = call()
    assert tuple(out.shape) == shape and out.dtype == dtype and out.device.type == "cuda"
    if name in ("max_pool", "max_pool_backward", "fused_stem"):
        assert out.is_contiguous(memory_format=torch.channels_last)
    assert all(fn.launches == 0 for fn in kernels.WRAPPERS.values())
    assert kernels.ceil_max_pool2d.backward_launches == 0


@pytest.mark.parametrize("case", ["mha_sequence", "pe_groups", "conv3x3_channels",
                                  "consensus_features"])
def test_op_fake_implementation_refuses(case):
    """A shape the kernel cannot take is refused while tracing, as on the
    card, with the wrapper's message."""
    with FakeTensorMode():
        def e(*shape, dtype=BF16):
            return torch.empty(*shape, dtype=dtype, device="cuda")

        calls = {
            "mha_sequence": (lambda: kernels.mha(e(2, 64), e(2, 80, 64), e(192, 64), e(192),
                                                 e(64, 64), e(64), 4), "sequence 80"),
            "pe_groups": (lambda: kernels.pe_block_bf16(
                e(2, 8, 64), (e(64, 64), e(8, 64, dtype=torch.float32)), e(64), e(64), 32),
                "channels per group"),
            "conv3x3_channels": (lambda: kernels.conv3x3(e(1, 4, 4, 12), e(8, 12, 3, 3),
                                                         e(8, dtype=torch.float32)),
                                 "multiples of 8"),
            "consensus_features": (lambda: kernels._consensus_heads_op(
                e(2, 3, 256), [e(125, 512)], [e(125)]), "outside the kernel's range"),
        }
        call, message = calls[case]
        with pytest.raises(ValueError, match=message):
            call()


def test_ops_have_no_cpu_kernel():
    """The ops are registered for CUDA only: a CPU tensor handed to one
    directly raises rather than running anything else (the wrappers send
    CPU tensors to the plain versions before any op)."""
    for name in ("pe_block", "pe_block_bf16", "mha", "max_pool", "max_pool_backward",
                 "fused_stem", "consensus_heads", "conv3x3"):
        assert hasattr(torch.ops.tbn, name), name
    with pytest.raises(NotImplementedError):
        torch.ops.tbn.conv3x3(torch.zeros(1, 4, 4, 8), torch.zeros(8, 8, 3, 3), torch.zeros(8))
    with pytest.raises(NotImplementedError):
        torch.ops.tbn.max_pool(torch.zeros(1, 2, 5, 5), False)
