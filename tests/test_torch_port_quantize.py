"""The port's int8 compute path (``tpu.quantize``) against the JAX package's.

One tri-modal case (RGB + Flow + Audio, MHA attention, 64-px crops, 2
segments, 1.279 s audio, float32; BatchNorm randomized): the port's weights
go to JAX through the bridge, and both sides calibrate on the same two
seeded batches. Checked:

* per int8 site, the port's int8 weight and dequantize scale (s_k * x_scale)
  bit-equal to the JAX package's formula (``layers.conv2d_apply_q``) on its
  own fold of the same variables, site by site in forward order (the merged
  1x1 in JAX's column order, the avg branch's proj / 9);
* ``qconv_plain`` against ``conv2d_apply_q`` at 1x1 / 3x3, stride 1 / 2,
  pad 0 / 1: the int32 sums exact, the int8 input bit-equal, the float32
  output within one ulp (XLA may contract the dequantize into an FMA);
* the calibration: 126 sites, the JAX tree's names, amaxes within rtol 1e-5
  (the port's float eval is unmerged, JAX's merged: rounding only), a
  running max over the two batches; the calibration forward equal to the
  plain eval forward; the state dict's keys unchanged;
* the int8 stages with JAX's amaxes carried across, each on the JAX
  package's input to it, at float32: all but a few elements within ulps
  (values on the edge of a rounding step; see the test); the whole int8
  forward's logits within rel-RMSE 0.04 (the repo's bf16 drift bound) at
  float32 and bf16: end to end, two int8 forwards decorrelate;
* the refusals: an uncalibrated int8 forward, non-BN-Inception, unmerged and
  unknown modes, the drivers; no amax at creation; training ignores it.

The JAX side compiles three programs (calibration, the int8 forward at
float32 and at bf16), traced one after another and compiled in threads: the
module stays near half a minute alone. JAX is imported inside the fixtures,
so that the card's machine, which has no JAX, can run the kernel test.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from attention_based_tbn_tpu_torch.models import layers
from attention_based_tbn_tpu_torch.models.bn_inception import (
    BN_INCEPTION_BLOCKS, QUANT_SITES, BNInception,
)
from attention_based_tbn_tpu_torch.models.bridge import (
    load_quant_stats, quant_stats_to_jax, state_dict_to_jax,
)
from attention_based_tbn_tpu_torch.models.tbn import TBNModel, TBNSpec, calibrate_quantization
from attention_based_tbn_tpu_torch.ops import kernels

TOWERS = ("Base_RGB", "Base_Flow", "Base_Audio")
SEEDS = (0, 1)  # the two calibration batches; the first is also the one compared


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_rmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(a ** 2)) + 1e-12))


def _to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _zero_quant_stats(jnp):
    """The JAX quant_stats tree of the tri-modal model, zeroed, from the
    port's site names: JAX's calibration starts from it (no eval_shape
    trace), and the int8 programs are traced against its structure."""
    tree = {}
    for tower in TOWERS:
        for site in QUANT_SITES:
            cell, leaf = site.split("/")
            tree.setdefault(tower, {}).setdefault(cell, {})[leaf] = jnp.zeros((), jnp.float32)
    return tree


def _stage_module(module, method: str) -> bool:
    """The JAX modules whose outputs the block-by-block test reads."""
    return method == "__call__" and type(module).__name__ in ("ConvBN", "InceptionBlock")


@pytest.fixture(scope="module")
def case():
    import jax
    import jax.numpy as jnp
    from torch_port_helpers import configs, make_batch, randomize_batchnorm
    from attention_based_tbn_tpu.models.tbn import TBNModel as JaxTBNModel
    from attention_based_tbn_tpu.models.tbn import TBNSpec as JaxTBNSpec
    from attention_based_tbn_tpu.models.tbn import calibrate_quantization as jax_calibrate
    from attention_based_tbn_tpu_torch.utils.misc import get_modality

    cfg, jcfg = configs(["tpu.quantize=int8"])
    spec = TBNSpec.from_config(cfg, get_modality(cfg))
    model = TBNModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(0))
    randomize_batchnorm(model).eval()
    batches = [make_batch(cfg, b=1, seed=s) for s in SEEDS]

    jspec = JaxTBNSpec.from_config(jcfg, get_modality(jcfg))
    variables = jax.tree.map(jnp.asarray, state_dict_to_jax(model.state_dict()))
    zeroed = {**variables, "quant_stats": _zero_quant_stats(jnp)}
    forwards = {}
    with ThreadPoolExecutor(2) as pool:  # compiles overlap the next trace
        for dtype in ("float32", "bfloat16"):
            # float32 also returns every module's output (the blocks' inputs)
            qmodel = JaxTBNModel(dataclasses.replace(jspec, compute_dtype=dtype))
            captures = dict(capture_intermediates=_stage_module, mutable=["intermediates"]) \
                if dtype == "float32" else {}
            lowered = jax.jit(lambda v, b, m=qmodel, kw=captures: m.apply(
                v, b, train=False, **kw)).lower(zeroed, batches[0])
            forwards[dtype] = pool.submit(lowered.compile)
        jvars = jax_calibrate(jspec, zeroed, batches)
        jax_out = {dtype: jax.tree.map(np.asarray, f.result()(jvars, batches[0]))
                   for dtype, f in forwards.items()}
    jax_out["float32"], captured = jax_out["float32"]
    jax_stats = jax.tree.map(np.asarray, jvars["quant_stats"])

    plain = TBNModel(dataclasses.replace(spec, quantize=""))
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        plain_out = plain.eval()(_to_torch(batches[0]))
    keys_before = list(model.state_dict())
    calibrate_quantization(model, [_to_torch(b) for b in batches])
    return dict(cfg=cfg, spec=spec, jspec=jspec, model=model, batches=batches, variables=variables,
                jax_stats=jax_stats, jax_out=jax_out, plain_out=plain_out,
                jax_modules=captured["intermediates"],
                keys_before=keys_before)


# ------------------------------------------------------------ calibration


def test_calibration_matches_jax(case):
    ported = quant_stats_to_jax(case["model"])
    want = case["jax_stats"]
    flat = {(t, c, leaf): v for t, cells in want.items() for c, leaves in cells.items()
            for leaf, v in leaves.items()}
    got = {(t, c, leaf): v for t, cells in ported.items() for c, leaves in cells.items()
           for leaf, v in leaves.items()}
    assert len(flat) == 126 and set(got) == set(flat)
    for key, value in flat.items():
        assert value > 0, key
        np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=str(key))


def test_calibration_is_a_running_max(case):
    """Each batch alone gives at most the pair's amax, and the pair's is
    the larger of the two, site by site; a larger amax already there is
    kept (max-merged, not overwritten)."""
    model = case["model"]
    pair = quant_stats_to_jax(model)
    singles = []
    for batch in case["batches"]:
        fresh = TBNModel(case["spec"])
        fresh.load_state_dict(model.state_dict())
        singles.append(quant_stats_to_jax(calibrate_quantization(fresh, [_to_torch(batch)])))
    for tower, cells in pair.items():
        for cell, leaves in cells.items():
            for leaf, value in leaves.items():
                each = [s[tower][cell][leaf] for s in singles]
                assert value == max(each), (tower, cell, leaf)
    huge = {t: {c: {leaf: np.float32(1e9) for leaf in leaves} for c, leaves in cells.items()}
            for t, cells in pair.items()}
    load_quant_stats(fresh, huge)
    calibrate_quantization(fresh, [_to_torch(case["batches"][0])])
    kept = quant_stats_to_jax(fresh)
    assert all(kept[t][c][leaf] == 1e9 for t, cells in huge.items()
               for c, leaves in cells.items() for leaf in leaves)


def test_calibration_forward_equals_plain_eval(case):
    model = TBNModel(case["spec"])
    model.load_state_dict(case["model"].state_dict())
    model.eval()
    for tower in TOWERS:
        getattr(model, tower).quantize = "calibrate"
    with torch.no_grad():
        out = model(_to_torch(case["batches"][0]))
    for key, want in case["plain_out"].items():
        torch.testing.assert_close(out[key], want, rtol=0, atol=0)


def test_state_dict_keys_unchanged_by_calibration(case):
    model = case["model"]
    assert list(model.state_dict()) == case["keys_before"]
    assert all(len(getattr(model, t).quant_stats()) == 42 for t in TOWERS)
    fresh = TBNModel(case["spec"])
    fresh.load_state_dict(model.state_dict(), strict=True)  # no amax in the file
    assert all(not getattr(fresh, t).quant_stats() for t in TOWERS)


def test_quant_stats_bridge_round_trip(case):
    tree = quant_stats_to_jax(case["model"])
    fresh = TBNModel(case["spec"])
    load_quant_stats(fresh, tree)
    again = quant_stats_to_jax(fresh)
    assert again.keys() == tree.keys()
    for tower in tree:
        for cell, leaves in tree[tower].items():
            for leaf, value in leaves.items():
                assert again[tower][cell][leaf] == value


# -------------------------------------------------------- the int8 sites


def _jax_site_operands(tower_module, quant_stats, tower):
    """(int8 (C_out, KH, KW, C_in), float32 s_k * x_scale) of every int8
    site of a tower in the port's forward order, by the JAX package's
    formulas: the merged heads of _fused_eval (bn_inception.py:381-410) and
    conv2d_apply_q's quantization (layers.py:86-95; numpy here, JAX's own
    lines are held to it in test_qconv_plain_matches_conv2d_apply_q), on the port's float32
    folds (the two frameworks' rsqrt differ in the last bit: the folds'
    agreement is test_folds_match_jax's)."""
    qs = quant_stats[tower]

    def folded(name):
        return _port_fold(tower_module, name)

    def q(kernel, amax):  # conv2d_apply_q's lines, in numpy float32 (IEEE, as XLA's)
        s_k = np.maximum(np.max(np.abs(kernel), axis=(0, 1, 2)) / np.float32(127.0),
                         np.float32(1e-12))
        kq = np.clip(np.round(kernel / s_k), -127, 127).astype(np.int8)
        x_scale = np.maximum(np.float32(amax), np.float32(1e-6)) / np.float32(127.0)
        return np.transpose(kq, (3, 0, 1, 2)), s_k * x_scale

    out = [q(folded(c), qs[c]["amax"]) for c in ("conv2_3x3_reduce", "conv2_3x3")]
    cells = ("1x1", "3x3_reduce", "3x3", "double_3x3_reduce", "double_3x3_1", "double_3x3_2",
             "pool_proj")
    for name, s in BN_INCEPTION_BLOCKS:
        a = qs[name]
        k = {cell: folded(f"{name}_{cell}") for cell in cells
             if hasattr(tower_module, f"{name}_{cell}")}
        heads = [k["pool_proj"] / np.float32(9.0)] if s.proj and s.pool == "avg" else []
        heads += ([k["1x1"]] if s.b1x1 else []) + [k["3x3_reduce"], k["double_3x3_reduce"]]
        out.append(q(np.concatenate(heads, axis=-1), a["in_amax"]))
        out.append(q(k["3x3"], a["r3_amax"]))
        out.append(q(k["double_3x3_1"], a["rd_amax"]))
        out.append(q(k["double_3x3_2"], a["d_amax"]))
        if s.proj and s.pool == "max":
            out.append(q(k["pool_proj"], a["in_amax"]))
    return out


def _port_fold(tower_module, name):
    """The port's float32 BN fold of one cell, HWIO as the JAX package's."""
    w, _ = layers.fold_conv_bn(getattr(tower_module, name), getattr(tower_module, f"{name}_bn"),
                               torch.float32)
    return np.transpose(w.detach().numpy(), (2, 3, 1, 0))


@pytest.mark.parametrize("tower", TOWERS)
def test_folds_match_jax(case, tower):
    """The port's fold, in FoldedConvBN's order, against the JAX package's
    (layers.py:495-500) on the bridged variables: equal but for rsqrt's
    last bit."""
    import jax
    params, stats = case["variables"]["params"][tower], case["variables"]["batch_stats"][tower]
    for name in ("conv2_3x3_reduce", "inception_3a_pool_proj", "inception_5b_double_3x3_2"):
        path = name.split("_", 2)[:2] + [name.split("_", 2)[2]] if name.startswith(
            "inception") else [name]
        path = ["_".join(path[:2]), path[2]] if len(path) == 3 else path
        p, s = params, stats
        for key in path:
            p, s = p[key], s[key]
        fold = jax.lax.rsqrt(s["bn"]["var"] + 1e-5) * p["bn"]["scale"]
        want = np.asarray(p["conv"]["kernel"] * fold)
        np.testing.assert_allclose(_port_fold(getattr(case["model"], tower), name), want,
                                   rtol=3e-7, atol=0, err_msg=name)


@pytest.fixture(scope="module")
def qconv_calls(case):
    """The (int8 weight, scale) of every qconv launch of one int8 forward
    with JAX's amaxes, in order: the towers run in modality order."""
    model = TBNModel(case["spec"])
    model.load_state_dict(case["model"].state_dict())
    load_quant_stats(model, case["jax_stats"])
    with torch.no_grad(), layers.recording_sites() as sites:
        model.eval()(_to_torch(case["batches"][0]))
    return [(args[1].numpy().copy(), args[2].numpy().copy())
            for kind, args, *_ in sites if kind == "qconv"]


@pytest.mark.parametrize("tower", TOWERS)
def test_site_operands_bit_equal_to_jax(case, qconv_calls, tower):
    """The int8 weight and the dequantize scale the port's forward hands
    qconv, site by site (43 launches a tower: 42 sites, inception_5b's
    in_amax twice), equal to the JAX package's bits."""
    assert len(qconv_calls) == 43 * len(TOWERS)
    index = TOWERS.index(tower)
    calls = qconv_calls[43 * index:43 * (index + 1)]
    want = _jax_site_operands(getattr(case["model"], tower), case["jax_stats"], tower)
    assert len(want) == 43
    for i, ((w8, scale), (w8_jax, scale_jax)) in enumerate(zip(calls, want)):
        np.testing.assert_array_equal(w8, w8_jax, err_msg=f"site {i}")
        np.testing.assert_array_equal(scale, scale_jax, err_msg=f"site {i}")


# Teacher-forced stages (the test below): an element differs when it is
# off JAX's by more than STAGE_ATOL x the stage's largest |output|; at most
# STAGE_DIFFERING of a stage's elements may, and its rel-RMSE stays under
# STAGE_REL_RMSE. A wiring fault (a column order, a ReLU, the / 9, a bias,
# an amax) changes a whole branch: 1/8 of a stage's outputs or more (3a's
# 32-channel proj of 256).
STAGE_ATOL = 1e-5
STAGE_DIFFERING = 0.02
STAGE_REL_RMSE = 1e-2
# The int8 logits' least rel-RMSE from the float forward's at the same type
# (measured 0.022 at float32, 0.022 to 0.024 at bf16): a quantization that did nothing
# would come in under it.
INT8_APART = 5e-3


@pytest.mark.parametrize("tower", TOWERS)
def test_int8_sites_match_jax_block_by_block(case, tower):
    """Each int8 stage of a tower (the two conv2 cells, the ten blocks) on
    the JAX package's own input to it, against the JAX package's output,
    at float32. Stages take JAX's inputs because two int8 forwards drift
    apart end to end: the frameworks' float stems differ by ~3e-7
    relative, enough to move a few activations across a rounding step at
    the first int8 site, and each 1-LSB change moves more at the next.
    Within a stage the same happens at a few elements: XLA on the CPU
    contracts the dequantize into an FMA in some fusions and not in others
    (one rounding or two: an ulp apart), and the two frameworks' rsqrt
    differ in the last bit of the BatchNorm fold, so a value or a weight
    on the edge of a rounding step may round the other way. Measured: 23
    of 36 stages within 1e-7 (ulps), the rest 2.6e-6 to 8.5e-4 with at
    most 0.78% of their elements differing (Base_Audio's inception_4c)."""
    jax_tower = case["jax_modules"][tower]
    model = TBNModel(case["spec"])
    model.load_state_dict(case["model"].state_dict())
    load_quant_stats(model, case["jax_stats"])
    net = getattr(model, tower).eval()

    def nchw(name):
        return torch.as_tensor(np.asarray(jax_tower[name]["__call__"][0])).permute(0, 3, 1, 2)

    stages = [("conv2_3x3_reduce", lambda: net._qcbr("conv2_3x3_reduce",
                                                     net._max_pool(nchw("conv1_7x7_s2"), 2, 0))),
              ("conv2_3x3", lambda: net._qcbr("conv2_3x3", nchw("conv2_3x3_reduce")))]
    previous = None
    for name, s in BN_INCEPTION_BLOCKS:
        x = net._max_pool(nchw("conv2_3x3"), 2, 0) if previous is None else nchw(previous)
        stages.append((name, lambda name=name, s=s, x=x: net._qblock(name, s, x)))
        previous = name
    for name, stage in stages:
        with torch.no_grad():
            got = stage().permute(0, 2, 3, 1).numpy()
        want = np.asarray(jax_tower[name]["__call__"][0])
        differing = float(np.mean(np.abs(got - want) > STAGE_ATOL * np.abs(want).max()))
        rel = _rel_rmse(want, got)
        assert differing <= STAGE_DIFFERING and rel <= STAGE_REL_RMSE, \
            f"{tower} {name}: {differing:.2%} of the elements differ, rel-RMSE {rel}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_forward_matches_jax(case, dtype):
    """The whole tri-modal int8 forward with JAX's amaxes against the JAX
    package's: rel-RMSE <= 0.04, the repo's bf16 drift bound, at both
    types. Two int8 forwards whose inputs differ by float rounding
    decorrelate through the 42 sites (see the block-by-block test); the
    gap measured 1.6e-4 to 1.4e-2 at float32 and 0.022 to 0.028 at bf16
    over two weight and two data seeds, the int8 forward's own distance to
    the float one 0.021 to 0.023. So the int8 logits must also stand
    apart from the port's float forward at the same type, by more than
    INT8_APART: the float path would pass the bound above."""
    bound = 0.04
    batch = _to_torch(case["batches"][0])
    model = TBNModel(dataclasses.replace(case["spec"], compute_dtype=dtype))
    model.load_state_dict(case["model"].state_dict())
    load_quant_stats(model, case["jax_stats"])
    with torch.no_grad():
        out = model.eval()(batch)
        float_out = case["plain_out"]
        if dtype != "float32":
            plain = TBNModel(dataclasses.replace(case["spec"], quantize="", compute_dtype=dtype))
            plain.load_state_dict(case["model"].state_dict())
            float_out = plain.eval()(batch)
    for key in ("verb", "noun"):
        got = out[key].float().numpy()
        assert np.isfinite(got).all()
        rel = _rel_rmse(case["jax_out"][dtype][key], got)
        assert rel <= bound, f"{key} at {dtype}: rel-RMSE {rel}"
        # apart from the float logits, and near them (the JAX package's bound)
        apart = _rel_rmse(float_out[key].float().numpy(), got)
        assert INT8_APART < apart < 0.2, f"{key} at {dtype}: {apart} from the float forward"


@pytest.mark.parametrize("kernel,stride,padding", [
    (1, 1, 0), (1, 2, 0), (1, 1, 1), (1, 2, 1), (3, 1, 0), (3, 2, 0), (3, 1, 1), (3, 2, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qconv_plain_matches_conv2d_apply_q(kernel, stride, padding, dtype):
    import jax.numpy as jnp
    from attention_based_tbn_tpu.models.layers import conv2d_apply_q

    rng = np.random.default_rng(kernel * 10 + stride + padding)
    x = rng.standard_normal((2, 9, 11, 64)).astype(np.float32)  # NHWC, odd sizes
    kf = (rng.standard_normal((kernel, kernel, 64, 40)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(40).astype(np.float32)
    amax = np.float32(np.abs(x).max() * 0.8)  # some inputs clip
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x_j = jnp.asarray(x).astype(jdt)
    x_scale_j = jnp.maximum(jnp.asarray(amax), 1e-6) / 127.0
    want = np.asarray(conv2d_apply_q(x_j, jnp.asarray(kf), jnp.asarray(bias), stride, padding,
                                     jdt, x_scale_j).astype(jnp.float32))

    x_t = torch.as_tensor(np.asarray(x_j.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
    x_scale = layers.activation_scale(torch.tensor(amax))
    assert x_scale.item() == float(x_scale_j)
    xq = kernels.quantize_plain(x_t, x_scale)
    q_j = jnp.clip(jnp.round(x_j.astype(jnp.float32) / x_scale_j), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(q_j))
    w8, s_k = layers.quantize_weight(torch.as_tensor(np.transpose(kf, (3, 2, 0, 1))))
    s_k_j = jnp.maximum(jnp.max(jnp.abs(kf), axis=(0, 1, 2)) / 127.0, 1e-12)  # layers.py:86-87
    np.testing.assert_array_equal(s_k.numpy(), np.asarray(s_k_j))
    kq_j = jnp.clip(jnp.round(kf / s_k_j), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(w8.numpy(), np.transpose(np.asarray(kq_j), (3, 0, 1, 2)))
    # the int32 sums: unit scale, no bias, no ReLU (|acc| < 2^24: exact in float32)
    ones, zeros = torch.ones(40), torch.zeros(40)
    acc = kernels.qconv_plain(xq, w8, ones, zeros, stride, padding, 40, torch.float32)
    import jax
    acc_j = jax.lax.conv_general_dilated(
        q_j, jnp.asarray(np.transpose(w8.numpy(), (1, 2, 3, 0))), (stride, stride),
        ((padding, padding), (padding, padding)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(acc_j).astype(np.float32))
    got = kernels.qconv_plain(xq, w8, s_k * x_scale, torch.as_tensor(bias), stride, padding,
                              40, tdt)
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        np.testing.assert_array_max_ulp(got, want, maxulp=1)
    else:  # the same fp32 values rounded once to bf16: at most one bf16 ulp apart
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def test_relu_from_spares_the_leading_columns():
    rng = np.random.default_rng(5)
    xq = torch.as_tensor(rng.integers(-127, 128, (1, 3, 3, 32)), dtype=torch.int8)
    w8 = torch.as_tensor(rng.integers(-127, 128, (8, 1, 1, 32)), dtype=torch.int8)
    scale, bias = torch.full((8,), 1e-3), torch.zeros(8)
    full = kernels.qconv_plain(xq, w8, scale, bias, 1, 0, 8, torch.float32)
    part = kernels.qconv_plain(xq, w8, scale, bias, 1, 0, 3, torch.float32)
    assert (full < 0).any()
    torch.testing.assert_close(part[:, :3], full[:, :3], rtol=0, atol=0)
    torch.testing.assert_close(part[:, 3:], full[:, 3:].clamp_min(0), rtol=0, atol=0)


def test_kernel_shape_checks_refuse_without_a_card():
    """What the kernels cannot take is refused (no fallback): C_in not a
    multiple of 32, a 5x5 kernel, stride 3, a bad relu_from; quantize's
    input with C 40 or split planes."""
    xq = torch.zeros((1, 8, 8, 64), dtype=torch.int8)
    w8 = torch.zeros((16, 3, 3, 64), dtype=torch.int8)
    s = torch.ones(16)
    assert kernels.qconv_shape_error(xq, w8, s, s, 1, 1, 0, torch.bfloat16) == ""
    assert "multiple of 32" in kernels.qconv_shape_error(
        xq[..., :48].contiguous(), w8[..., :48].contiguous(), s, s, 1, 1, 0, torch.float32)
    assert "wq" in kernels.qconv_shape_error(
        xq, torch.zeros((16, 5, 5, 64), dtype=torch.int8), s, s, 1, 2, 0, torch.float32)
    assert "stride" in kernels.qconv_shape_error(xq, w8, s, s, 3, 1, 0, torch.float32)
    assert "relu_from" in kernels.qconv_shape_error(xq, w8, s, s, 1, 1, 17, torch.float32)
    x_scale = torch.ones(1)
    x = torch.zeros((2, 64, 7, 7))
    assert kernels.quantize_shape_error(x, x_scale) == ""
    assert kernels.quantize_shape_error(x[:, 32:], x_scale) == ""  # a channel slice
    assert "multiple of 32" in kernels.quantize_shape_error(x[:, :40], x_scale)
    channels_last = x.contiguous(memory_format=torch.channels_last)
    assert kernels.quantize_layout(channels_last[:, 32:]) == "channels"
    assert kernels.quantize_shape_error(channels_last[:, 32:], x_scale) == ""
    assert "contiguous" in kernels.quantize_shape_error(x.permute(0, 1, 3, 2), x_scale)


# ---------------------------------------------------------------- refusals


def test_uncalibrated_int8_forward_raises(case):
    model = TBNModel(case["spec"])
    model.load_state_dict(case["model"].state_dict())
    with pytest.raises(ValueError, match="calibrate_quantization"):
        with torch.no_grad():
            model.eval()(_to_torch(case["batches"][0]))


def test_creation_makes_no_quant_stats(case):
    model = TBNModel(case["spec"])
    assert all(not getattr(model, t).quant_stats() for t in TOWERS)
    assert not any(name.startswith("quant_") or ".quant_" in name
                   for name, _ in model.named_buffers())


def test_training_ignores_quantize(case):
    model = TBNModel(case["spec"])
    model.load_state_dict(case["model"].state_dict())
    out = model.train()(_to_torch(case["batches"][0]), generator=torch.Generator())
    assert np.isfinite(out["verb"].detach().numpy()).all()
    assert all(not getattr(model, t).quant_stats() for t in TOWERS)


@pytest.mark.parametrize("change,match", [
    (dict(arch="resnet", attention_enable=False), "bninception"),
    (dict(merge_inception=False), "merge_inception"),
    (dict(quantize="fp4"), "quantize"),
])
def test_spec_refusals_as_jax(case, change, match):
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(case["jspec"], **change).validate()
    with pytest.raises(ValueError, match=match):
        dataclasses.replace(case["spec"], **change).validate()


def test_tower_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="quantize"):
        BNInception(3, quantize="int4")


def test_calibration_refuses_no_batches_and_other_towers(case):
    model = TBNModel(case["spec"])
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate_quantization(model, [])
    resnet = TBNModel(dataclasses.replace(case["spec"], arch="resnet", resnet_depth=18,
                                          attention_enable=False, quantize=""))
    with pytest.raises(ValueError, match="bninception"):
        calibrate_quantization(resnet, [_to_torch(case["batches"][0])])


def test_drivers_fail_fast(case):
    from attention_based_tbn_tpu_torch.models.builder import build_model
    from attention_based_tbn_tpu_torch.utils.misc import get_modality
    with pytest.raises(ValueError, match="calibrate_quantization"):
        build_model(case["cfg"], get_modality(case["cfg"]), device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_equal_plain_on_the_card(dtype):
    """quantize and qconv bit-equal to their plain versions at BN-Inception
    site shapes (1x1 merged, 3x3 stride 1 and 2, a channel slice), with
    the all-float output and with the segment contract: a float segment
    into a channel slice of a channels-last buffer (its other channels
    untouched), a scratch float segment and two int8 ones for the next
    sites, as a block's merged 1x1 writes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c_in, c_out, h, k, stride in ((192, 256, 28, 1, 1), (64, 96, 28, 3, 1),
                                      (128, 160, 28, 3, 2), (576, 352, 14, 1, 1)):
        x = torch.randn((3, c_in + 32, h, h), device="cuda", generator=gen).to(dtype)
        if stride == 2:  # the channels-last layout of cuDNN's outputs
            x = x.contiguous(memory_format=torch.channels_last)
        x = x[:, 32:]
        x_scale = layers.activation_scale(x.float().abs().amax() * 0.9)
        xq = kernels.quantize(x, x_scale)
        assert torch.equal(xq, kernels.quantize_plain(x, x_scale))
        kf = torch.randn((c_out, c_in, k, k), device="cuda", generator=gen) * 0.05
        w8, s_k = layers.quantize_weight(kf)
        bias = torch.randn(c_out, device="cuda", generator=gen)
        pad = 1 if k == 3 else 0
        args = (xq, w8, s_k * x_scale, bias, stride, pad, 32, dtype)
        got = kernels.qconv(*args)
        want = kernels.qconv_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (c_in, c_out, h, k, stride)
        if c_out <= 96:
            continue
        # the segments: [32 float scratch | a slice of a wider buffer | int8 | int8]
        b, ho, wo = want.shape[0], want.shape[2], want.shape[3]
        widths = (32, c_out - 96, 32, 32)
        results = []
        for run in (kernels.qconv, kernels.qconv_plain):
            buffer = torch.full((b, widths[1] + 64, ho, wo), 7.0, device="cuda",
                                dtype=dtype).contiguous(memory_format=torch.channels_last)
            segments = [(torch.empty((b, ho, wo, 32), device="cuda", dtype=dtype), None),
                        (layers.nhwc(buffer)[..., 32:32 + widths[1]], None)]
            segments += [(torch.empty((b, ho, wo, 32), device="cuda", dtype=torch.int8),
                          layers.activation_scale(torch.tensor(v, device="cuda")))
                         for v in (3.0, 11.0)]
            run(*args, segments=segments)
            results.append([out for out, _ in segments] + [buffer])
        torch.cuda.synchronize()
        for got_t, want_t in zip(*results):
            assert torch.equal(got_t, want_t), (c_in, c_out, h, k, stride)
