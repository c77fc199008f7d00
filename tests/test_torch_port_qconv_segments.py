"""The int8 sites' segment contract (``kernels.qconv`` with ``segments``)
and the int8 towers' channels-last plumbing, on the CPU.

The kernel (ops/csrc/qconv.cu) writes its output channels-last into up to
four column segments: float ones in the compute type into NHWC views at any
pixel stride (a channel slice of a block's output buffer), int8 ones
quantized for the next site. Its plain version is the reference
composition. Checked here, all bit for bit:

* the segment ``qconv_plain`` against the composition it replaces:
  ``qconv_plain`` to the compute type, then channel slices, then
  ``quantize_plain`` (1x1 and 3x3, stride 1 and 2, fp32 and bf16, a merged
  site with ``relu_from`` > 0, a slice of a channels-last buffer whose other
  channels stay untouched);
* the tower: each stage of an int8 BN-Inception tower (the conv2 pair, the
  ten blocks) against the same stage composed as before (a quantize before
  every site, the float output of every site, ``torch.cat`` of the
  branches), and the route counts of a b=1 forward: 12 standalone
  quantizes, 31 folded ones and 43 convolutions a tower;
* the refusals the kernel's wrapper makes without a card: a segment off a
  32-channel boundary, a view not on 16 bytes, more than four segments,
  and the rest of the contract.

No JAX here: the JAX side of the int8 path is in test_torch_port_quantize.py.
"""

import pytest
import torch
import torch.nn.functional as F

from attention_based_tbn_tpu_torch.models import layers
from attention_based_tbn_tpu_torch.models.bn_inception import (BN_INCEPTION_BLOCKS,
                                                               BNInception)
from attention_based_tbn_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _site(seed, b, h, w, c_in, c_out, k, stride):
    gen = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (b, h, w, c_in), dtype=torch.int8, generator=gen)
    wq = torch.randint(-127, 128, (c_out, k, k, c_in), dtype=torch.int8, generator=gen)
    scale = torch.rand(c_out, generator=gen) * 1e-4
    bias = torch.randn(c_out, generator=gen)
    return xq, wq, scale, bias


# (kernel, stride, C_in, C_out, segments as (width, kind), relu_from): kind
# "float" a scratch NHWC tensor, "slice" channels [32, 32 + width) of a
# wider channels-last buffer, "int8" quantized with a scale of its own
SEGMENT_CASES = {
    "1x1_one_float": (1, 1, 64, 64, [(64, "float")], 0),
    "1x1_one_int8": (1, 1, 64, 64, [(64, "int8")], 0),
    "1x1_merged_avg_block": (1, 1, 192, 224, [(32, "float"), (64, "slice"), (64, "int8"),
                                                (64, "int8")], 32),
    "1x1_merged_max_block": (1, 1, 320, 192, [(128, "int8"), (64, "int8")], 0),
    "3x3_stride1_slice": (3, 1, 96, 128, [(128, "slice")], 0),
    "3x3_stride1_int8": (3, 1, 160, 96, [(96, "int8")], 0),
    "3x3_stride2_slice": (3, 2, 64, 96, [(96, "slice")], 0),
    "3x3_stride2_float": (3, 2, 128, 160, [(160, "float")], 0),
}


def _outputs(segments, shape, dtype, gen):
    """Fresh destinations: a slice's buffer filled with a marker."""
    b, ho, wo, _ = shape
    outs, buffers = [], []
    for width, kind in segments:
        if kind == "int8":
            outs.append((torch.zeros((b, ho, wo, width), dtype=torch.int8),
                         layers.activation_scale(torch.rand((), generator=gen) * 4 + 0.5)))
        elif kind == "slice":
            buffer = torch.full((b, width + 64, ho, wo), 7.0, dtype=dtype).contiguous(
                memory_format=torch.channels_last)
            buffers.append(buffer)
            outs.append((layers.nhwc(buffer)[..., 32:32 + width], None))
        else:
            outs.append((torch.zeros((b, ho, wo, width), dtype=dtype), None))
    return outs, buffers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segment_plain_equals_the_composition(case, dtype):
    """Each segment equals the composition it replaces: the whole output
    rounded to the compute type, its channel slice, and (int8)
    ``quantize_plain`` of that slice; a slice's buffer keeps its other
    channels."""
    k, stride, c_in, c_out, segments, relu_from = SEGMENT_CASES[case]
    xq, wq, scale, bias = _site(len(case), 2, 9, 11, c_in, c_out, k, stride)
    padding = 1 if k == 3 else 0
    args = (xq, wq, scale, bias, stride, padding, relu_from, dtype)
    shape = kernels.qconv_output_shape(xq, wq, stride, padding)
    outs, buffers = _outputs(segments, shape, dtype, torch.Generator().manual_seed(3))
    assert kernels._qconv_args_error(*args, [o for o, _ in outs], [s for _, s in outs],
                                     True) == ""
    assert kernels.qconv(*args, segments=outs) is None
    whole = kernels.qconv_plain(*args)
    assert whole.dtype == dtype and tuple(whole.shape) == (shape[0], c_out, *shape[1:3])
    begin = 0
    for out, x_scale in outs:
        part = whole[:, begin:begin + out.shape[-1]]
        want = (part.permute(0, 2, 3, 1) if x_scale is None
                else kernels.quantize_plain(part, x_scale))
        assert out.dtype == want.dtype and torch.equal(out, want), (case, begin)
        begin += out.shape[-1]
    for buffer in buffers:
        assert (buffer[:, :32] == 7.0).all() and (buffer[:, -32:] == 7.0).all()
    # no segments: the all-float output, channels-last on a card, NCHW here
    assert torch.equal(kernels.qconv(*args), whole)


def test_relu_from_spares_the_proj_columns_of_a_merged_segment():
    xq, wq, scale, bias = _site(9, 1, 5, 5, 64, 96, 1, 1)
    outs = [(torch.empty((1, 5, 5, 32)), None), (torch.empty((1, 5, 5, 64)), None)]
    kernels.qconv(xq, wq, scale, bias, 1, 0, 32, torch.float32, segments=outs)
    assert (outs[0][0] < 0).any() and (outs[1][0] >= 0).all()


# ------------------------------------------------------------- the tower


@pytest.fixture(scope="module")
def tower():
    """A calibrated int8 BN-Inception tower (random BatchNorm) on 64-px
    RGB-sized input, and a float batch of 2 images."""
    gen = torch.Generator().manual_seed(0)
    net = BNInception(3, quantize="calibrate")
    net.reset_parameters(gen)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if name.endswith("_bn.weight") or name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith("bias") or name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    net.eval()
    x = torch.randn((2, 3, 64, 64), generator=gen)
    with torch.no_grad():
        net(x, torch.float32)
    net.quantize = "int8"
    return net, x


def _composed_site(x, operands, stride, padding, relu_from=0):
    """One site as separate passes: quantize, then the float output."""
    w8, scale, bias, x_scale = operands
    return kernels.qconv_plain(kernels.quantize_plain(x, x_scale), w8, scale, bias, stride,
                               padding, relu_from, x.dtype)


def _composed_block(net, name, s, x):
    """An int8 block as separate passes: a quantize before every site,
    every site's float output, the branches concatenated."""
    merge_proj = bool(s.proj) and s.pool == "avg"
    cells = [f"{name}_{c}" for c in (["pool_proj"] if merge_proj else [])
             + (["1x1"] if s.b1x1 else []) + ["3x3_reduce", "double_3x3_reduce"]]
    sizes = [getattr(net, c).out_channels for c in cells]
    merged = _composed_site(x, net._q_operands(f"{name}/in", cells, f"{name}/in_amax",
                                               merge_proj), 1, 0,
                            sizes[0] if merge_proj else 0)
    parts = list(torch.split(merged, sizes, dim=1))
    proj = parts.pop(0) if merge_proj else None
    branches = [parts.pop(0)] if s.b1x1 else []
    r3, rd = parts

    def conv3x3(cell, inp, site, stride):
        cell = f"{name}_{cell}"
        return _composed_site(inp, net._cell_operands(cell, f"{name}/{site}"), stride, 1)

    branches.append(conv3x3("3x3", r3, "r3_amax", s.stride))
    d = conv3x3("double_3x3_1", rd, "rd_amax", 1)
    branches.append(conv3x3("double_3x3_2", d, "d_amax", s.stride))
    if merge_proj:
        cell = f"{name}_pool_proj"
        _, bias = net._folded.get(f"{cell}/bias", getattr(net, cell),
                                  getattr(net, f"{cell}_bn"), torch.float32, proj.dtype)
        padded = F.pad(proj, (1, 1, 1, 1))
        h, w = proj.shape[2:]
        total = None
        for dy in range(3):
            for dx in range(3):
                tap = padded[:, :, dy:dy + h, dx:dx + w]
                total = tap if total is None else total + tap
        branches.append(F.relu(total + bias.view(1, -1, 1, 1)))
    elif s.proj:
        cell = f"{name}_pool_proj"
        branches.append(_composed_site(net._max_pool(x, 1, 1),
                                       net._cell_operands(cell, f"{name}/in_amax"), 1, 0))
    else:
        branches.append(net._max_pool(x, s.stride, 0))
    return torch.cat(branches, dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_tower_stages_equal_the_composition(tower, dtype):
    """The conv2 pair and each block of the int8 tower, on the same input,
    bit-equal to the separate passes; each block's output one channels-last
    buffer."""
    net, x = tower
    with torch.no_grad():
        y = net._max_pool(net._cbr("conv1_7x7_s2", x.to(dtype)), 2, 0)
        got = net._qconv2(y)
        want = _composed_site(_composed_site(y, net._cell_operands(
            "conv2_3x3_reduce", "conv2_3x3_reduce/amax"), 1, 0),
            net._cell_operands("conv2_3x3", "conv2_3x3/amax"), 1, 1)
        assert torch.equal(got, want)
        y = net._max_pool(got, 2, 0)
        for name, s in BN_INCEPTION_BLOCKS:
            got = net._qblock(name, s, y)
            assert got.is_contiguous(memory_format=torch.channels_last), name
            assert torch.equal(got, _composed_block(net, name, s, y)), name
            y = got


def test_tower_routes_of_a_forward(tower):
    """A b=1 forward's kernel calls through ``recording_sites``: 12
    standalone quantizes (conv2_3x3_reduce's input, the ten block inputs,
    inception_5b's pooled branch), 43 convolutions, and 31 int8 segments
    folded into the convolution that produces their input."""
    net, x = tower
    with torch.no_grad(), layers.recording_sites() as sites:
        net(x[:1], torch.bfloat16)
    quantizes = [s for s in sites if s[0] == "quantize"]
    convs = [s for s in sites if s[0] == "qconv"]
    folded = [x_scale for _, _, segments in convs for _, x_scale in segments
              if x_scale is not None]
    assert (len(quantizes), len(convs), len(folded)) == (12, 43, 31)
    assert all(len(segments) <= kernels.QCONV_MAX_SEGMENTS for _, _, segments in convs)


# -------------------------------------------------------------- refusals


def _refusal(segments, dtype=torch.bfloat16, shape=(2, 4, 4, 128)):
    return kernels.qconv_segments_error(segments, shape, dtype)


def test_segment_refusals_without_a_card():
    """What the kernel cannot write is refused before a launch."""
    b, h, w = 2, 4, 4
    scale = torch.ones(1)
    buffer = layers.channels_last((b, 160, h, w), torch.bfloat16, "cpu")
    view = layers.nhwc(buffer)
    assert _refusal([(view[..., 32:160], None)]) == ""
    # a segment off a 32-channel boundary
    assert "boundaries" in _refusal([(view[..., :48], None), (view[..., 48:128], None)])
    # a view that does not start on 16 bytes (4 bf16 channels in)
    assert "16 bytes" in _refusal([(view[..., 4:132], None)])
    # a pixel stride off 16 bytes: 136 int8 channels a pixel
    wide = torch.zeros((b, h, w, 136), dtype=torch.int8)
    assert "pixel stride" in _refusal([(wide[..., :128], scale)])
    # more than four segments
    fours = [(torch.zeros((b, h, w, 32), dtype=torch.bfloat16), None) for _ in range(5)]
    assert "not 1 to 4" in _refusal(fours, shape=(b, h, w, 160))
    assert "not 1 to 4" in _refusal([])
    # the rest of the contract
    assert "cover 96 of 128" in _refusal([(view[..., :96], None)])
    assert "float segment must be" in _refusal([(view[..., :128].float(), None)])
    assert "int8 segment" in _refusal([(view[..., :128], scale)])
    assert "is not (2, 4, 4, C)" in _refusal([(view[:1, ..., :128], None)])
    transposed = torch.zeros((b, w, h, 128), dtype=torch.bfloat16).transpose(1, 2)
    assert "one pixel stride" in _refusal([(transposed, None)])


def test_qconv_refuses_segments_on_the_op_path_without_a_card():
    """The op's fake implementation (what a trace sees) refuses the same,
    and declares the outputs as mutated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    schema = str(kernels._qconv_op._opoverload._schema)
    assert "Tensor(a8!)[] outs" in schema
    with FakeTensorMode():
        xq = torch.empty((2, 4, 4, 64), dtype=torch.int8, device="cuda")
        wq = torch.empty((96, 1, 1, 64), dtype=torch.int8, device="cuda")
        s = torch.empty(96, device="cuda")
        out = torch.empty((2, 4, 4, 96), dtype=torch.bfloat16, device="cuda")
        kernels._qconv_op(xq, wq, s, s, 1, 0, 0, torch.bfloat16, [out], [None])
        halves = [torch.empty((2, 4, 4, 48), dtype=torch.bfloat16, device="cuda")
                  for _ in range(2)]
        with pytest.raises(ValueError, match="boundaries"):
            kernels._qconv_op(xq, wq, s, s, 1, 0, 0, torch.bfloat16, halves, [None, None])
    assert kernels.qconv.launches == 0


def test_quantize_routes_without_a_card():
    """quantize's route by x's memory: NCHW planes; channels-last on 16
    bytes (the block buffers); channels-last off 16 bytes (narrow)."""
    x = torch.zeros((2, 96, 5, 5), dtype=torch.bfloat16)
    assert kernels.quantize_route(x) == "planes"
    channels = x.contiguous(memory_format=torch.channels_last)
    assert kernels.quantize_route(channels) == "channels"
    assert kernels.quantize_route(channels[:, 32:]) == "channels"
    assert kernels.quantize_route(channels[:, 4:68]) == "channels_narrow"
    odd = torch.zeros((2, 5, 5, 100), dtype=torch.bfloat16).permute(0, 3, 1, 2)[:, :96]
    assert kernels.quantize_route(odd) == "channels_narrow"


@pytest.mark.parametrize("shape,c_out,kernel,stride,want", [
    ((250, 16, 26, 576), 544, 1, 1, ("tma_flat", 192, 64, 1, 1, True)),
    ((1, 3, 3, 64), 64, 1, 1, ("tma_flat", 64, 9, 1, 1, True)),
    ((250, 56, 56, 64), 192, 3, 1, ("tma_box", 192, 8, 4, 2, True)),
    ((25, 28, 28, 128), 160, 3, 2, ("tma_box", 160, 14, 2, 2, False)),
    ((25, 7, 7, 1024), 832, 1, 1, ("tma_flat", 224, 64, 1, 1, False)),
    ((25, 7, 7, 192), 320, 3, 1, ("tma_box", 160, 7, 1, 9, False)),
])
def test_qconv_plan(shape, c_out, kernel, stride, want):
    """The kernel's walk, by shape: 1x1 / stride-1 sites as a plain GEMM,
    the rest as TMA boxes of at most 64 positions (the fewest boxes); N
    tiles from 64 to 256 channels by 32 covering C_out in the fewest
    tiles."""
    plan = kernels.qconv_plan(shape, c_out, kernel, stride, 1 if kernel == 3 else 0)
    assert tuple(plan) == want
    assert plan.box_w * plan.box_h * plan.box_i <= kernels.QCONV_TILE_ROWS
    assert plan.n_tile in kernels.QCONV_N_TILES
