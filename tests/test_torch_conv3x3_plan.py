"""The decoder's 3x3 conv (``ops/conv3x3.py``, kernel ``csrc/conv3x3.cu``) on
the CPU: the plain path is ``F.conv2d``, the plan's tiles and chunks cover
the work once (written out here as the kernel walks it), and the model
routes exactly its 2-D decoder's convs through it with its parameters and
module names unchanged. The kernel itself runs on the card only
(``tests/test_torch_kernels_cuda.py``)."""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference.model import RPEFlow as ReferenceRPEFlow
from chip_smoke import DECODER_CONVS, conv3x3_shapes
from rpeflow_tpu.compat.torch_loader import to_torch_state_dict
from rpeflow_tpu.model import RPEFlow as JaxRPEFlow
from rpeflow_tpu.train.config import ConfigNode as JaxConfigNode
from rpeflow_tpu_torch.model import RPEFlow
from rpeflow_tpu_torch.nn import pyramid2d
from rpeflow_tpu_torch.ops import _cuda, conv3x3
from rpeflow_tpu_torch.train.config import ConfigNode
from rpeflow_tpu_torch.utils.flops import FlopCount
from rpeflow_tpu_torch.utils.work import kernel_work
from torch_port_utils import fill_variables, make_inputs, small_cfg_dict

N_SAMPLES = (32, 16)
MODEL_KEYS = ("images", "pcs", "event_voxel", "intrinsics")
#: ragged pixel counts: one pixel, fewer than a tile, odd H and W
RAGGED = [(1, 1, 1), (2, 5, 3), (3, 7, 9)]


def _operands(shape, seed=0):
    b, h, w, cin, cout, _ = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=g)
    weight = torch.randn(cout, cin, 3, 3, generator=g) / (9 * cin) ** 0.5
    return x, weight, 0.1 * torch.randn(cout, generator=g)


@pytest.mark.parametrize("bhw", RAGGED, ids=str)
@pytest.mark.parametrize("conv", DECODER_CONVS, ids=str)
def test_plain_path_is_conv2d(conv, bhw):
    """On the CPU the forward is F.conv2d on the channels-last view, bit for
    bit, and launches nothing; the Function's gradients are F.conv2d's."""
    shape = (*bhw, *conv)
    x, weight, bias = _operands(shape)
    d = conv[2]
    want = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, 1, d, d).permute(0, 2, 3, 1)
    launches = _cuda.LAUNCHES["conv3x3"]
    assert torch.equal(conv3x3.conv3x3_fwd(x, weight, bias, d), want)
    assert _cuda.LAUNCHES["conv3x3"] == launches

    gout = torch.randn(*want.shape, generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (conv3x3.conv3x3_nhwc, conv3x3.conv3x3_plain):
        leaves = [t.clone().requires_grad_() for t in (x, weight, bias)]
        fn(*leaves, d).backward(gout)
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_function_without_bias_and_with_frozen_inputs():
    x, weight, _ = _operands((2, 6, 5, 20, 8, 2))
    xl, wl = x.clone().requires_grad_(), weight.clone()
    out = conv3x3.conv3x3_nhwc(xl, wl, None, 2)
    out.sum().backward()
    ref = xl.detach().clone().requires_grad_()
    conv3x3.conv3x3_plain(ref, weight, None, 2).sum().backward()
    torch.testing.assert_close(xl.grad, ref.grad, rtol=1e-6, atol=1e-6)


def test_flop_count_and_work():
    """A call counts 2 * 9 * Cin * Cout a pixel, once, as FlopCounterMode
    counts the F.conv2d it replaces; its bound reads the input, weights,
    bias and output once."""
    shape = (2, 5, 3, 243, 192, 1)
    x, weight, bias = _operands(shape)
    with FlopCount() as count:
        conv3x3.conv3x3_fwd(x, weight, bias, 1)
    flops = 2 * 9 * 243 * 192 * 30
    assert count.total == count.kernels["conv3x3"] == flops
    assert count.calls == [("conv3x3", shape)]
    nbytes, ops, tf32 = kernel_work("conv3x3", shape)
    assert ops == flops and tf32 == 0.0
    assert nbytes == 4 * (30 * (243 + 192) + 9 * 243 * 192 + 192)


# -- the plan -------------------------------------------------------------------


@pytest.mark.parametrize("cin,chunks16,tail16,copy", [(243, 16, 3, 4), (98, 7, 2, 8),
                                                      (192, 12, 16, 16), (96, 6, 16, 16)])
def test_plan_chunks_and_copies(cin, chunks16, tail16, copy):
    """243 = 15 x 16 + 3 and 98 = 6 x 16 + 2 channels: the last chunk holds
    the tail, zero-filled past Cin; 243-channel rows (972 bytes) go by
    4-byte copies, 98-channel rows by 8-byte copies, the others by 16."""
    plan = conv3x3.conv3x3_plan(4, 144, 240, cin, 192, 1)
    assert (plan.bm, plan.bn, plan.ck) == (128, 64, 16)
    assert (plan.chunks, plan.tail) == (chunks16, tail16)
    assert plan.copy_bytes == copy
    small = conv3x3.conv3x3_plan(3, 8, 10, cin, 128, 1)
    assert small.ck == 32 and small.chunks == -(-cin // 32)
    assert small.tail == cin - 32 * (small.chunks - 1)


def test_plan_grid_at_the_flagship_level_1():
    """conv1 at FT3D's level 1: 138,240 pixels in 1,080 tiles of 128, by 3
    tiles of 64 of its 192 channels."""
    plan = conv3x3.conv3x3_plan(4, 144, 240, 243, 192, 1)
    assert (plan.m_tiles, plan.n_tiles, plan.blocks) == (1080, 3, 3240)


@pytest.mark.parametrize("shape", list(dict.fromkeys(
    conv3x3_shapes(4, 576, 960) + conv3x3_shapes(3, 512, 640))), ids=str)
def test_plan_at_every_decoder_shape(shape):
    """Every decoder call gets a tile whose BN divides Cout, that gives the
    card's SMs MIN_BLOCKS_PER_SM blocks each unless it is the last tile,
    and whose shared memory leaves room for BLOCKS_PER_SM blocks an SM."""
    plan = conv3x3.conv3x3_plan(*shape)
    tile = (plan.bm, plan.bn, plan.ck)
    assert tile in conv3x3.TILES and shape[4] % plan.bn == 0
    assert tile == conv3x3.TILES[-1] or plan.blocks >= conv3x3.MIN_BLOCKS_PER_SM * 132
    assert conv3x3.BLOCKS_PER_SM * plan.smem_bytes <= conv3x3.SMEM_LIMIT


@pytest.mark.parametrize("tile", conv3x3.TILES, ids=str)
def test_tile_threads_cover_the_tile_once(tile):
    """The kernel's index arithmetic, written out: the 128 threads' staging
    units (pixel tid / G + (128 / G) r, channels 4 (tid % G) + [0, 4), G =
    CK / 4) cover the BM x CK input tile once, and their outputs (pixels
    tid / 8 + 16 i, channels 4 (tid % 8) + 32 half + [0, 4)) the BM x BN
    output tile once."""
    bm, bn, ck = tile
    groups, tm_, tn_ = ck // 4, bm // 16, bn // 8
    units = bm * groups // conv3x3.THREADS
    staged = [(tid // groups + conv3x3.THREADS // groups * r, 4 * (tid % groups) + q)
              for tid in range(conv3x3.THREADS) for r in range(units) for q in range(4)]
    assert sorted(staged) == [(m, c) for m in range(bm) for c in range(ck)]
    owned = [(tid // 8 + 16 * i, 4 * (tid % 8) + 32 * half + q)
             for tid in range(conv3x3.THREADS) for i in range(tm_)
             for half in range(tn_ // 4) for q in range(4)]
    assert sorted(owned) == [(m, n) for m in range(bm) for n in range(bn)]


def _walk(x, weight, bias, plan):
    """The kernel's walk written out in float64: for each block tile of
    pixels, chunk of ``ck`` channels (zero past Cin) and tap, the staged
    pixels shifted by the tap (zero outside the frame) times the chunk's
    weights of that tap, summed in the kernel's order."""
    b, h, w, cin = x.shape
    cout, d, ck = weight.shape[0], plan.d, plan.ck
    pad = plan.chunks * ck - cin
    xf = x.double().reshape(-1, cin)
    wf = F.pad(weight.double(), (0, 0, 0, 0, 0, pad))  # [Cout, chunks ck, 3, 3]
    out = torch.zeros(plan.m, cout, dtype=torch.float64)
    for m0 in range(0, plan.m, plan.bm):
        p = torch.arange(m0, min(m0 + plan.bm, plan.m))
        y, xx = (p % (h * w)) // w, p % w
        for chunk in range(plan.chunks):
            c0 = chunk * ck
            for tap in range(9):
                dy, dx = (tap // 3 - 1) * d, (tap % 3 - 1) * d
                inside = (y + dy >= 0) & (y + dy < h) & (xx + dx >= 0) & (xx + dx < w)
                src = torch.where(inside, p + dy * w + dx, 0)
                a = F.pad(xf[src], (0, pad))[:, c0:c0 + ck] * inside[:, None]
                out[p] += a @ wf[:, c0:c0 + ck, tap // 3, tap % 3].T
    return (out + bias.double()).reshape(b, h, w, cout)


@pytest.mark.parametrize("tile", conv3x3.TILES, ids=str)
@pytest.mark.parametrize("shape", [(2, 9, 7, 243, 64, 1), (1, 11, 13, 98, 32, 2),
                                   (3, 5, 6, 17, 36, 16)], ids=str)
def test_walk_of_the_plan_is_the_conv(shape, tile):
    """Chunks with a ragged tail, taps with a dilation wider than the map,
    M and Cout not multiples of the tile: the kernel's decomposition of K
    sums to F.conv2d."""
    x, weight, bias = _operands(shape)
    plan = conv3x3.conv3x3_plan(*shape, tile=tile)
    want = conv3x3.conv3x3_plain(x.double(), weight.double(), bias.double(), shape[5])
    torch.testing.assert_close(_walk(x, weight, bias, plan), want, rtol=1e-12, atol=1e-12)


def test_plan_refuses_what_the_kernel_cannot_run():
    for args in ((1, 8, 8, 32, 6, 1), (1, 8, 8, 32, 0, 1), (0, 8, 8, 32, 32, 1),
                 (1, 8, 8, 32, 32, 0), (1, 8, 8, 0, 32, 1), (8, 1024, 1024, 512, 64, 1)):
        with pytest.raises(ValueError):
            conv3x3.conv3x3_plan(*args)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_plan(1, 8, 8, 32, 32, 1, tile=(32, 32, 16))
    x, weight, bias = _operands((1, 4, 4, 8, 8, 1))
    with pytest.raises(ValueError):
        conv3x3.conv3x3_fwd(x, weight[:, :4], bias, 1)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_fwd(x, weight, bias[:4], 1)


# -- the model's routing ----------------------------------------------------------


@pytest.fixture
def routed(monkeypatch):
    """The calls of ``conv3x3_nhwc`` from the 2-D pyramid module: (Cin,
    Cout, dilation) each."""
    calls = []

    def recording(x, weight, bias, dilation=1):
        calls.append((x.shape[-1], weight.shape[0], dilation))
        return conv3x3.conv3x3_nhwc(x, weight, bias, dilation)

    monkeypatch.setattr(pyramid2d, "conv3x3_nhwc", recording)
    return calls


def test_decoder_modules_route_through_the_kernel(routed):
    flow = pyramid2d.FlowEstimator2D([243, 192, 128, 96, 64, 32])
    ctx = pyramid2d.ContextNetwork2D([98, 128, 128, 128, 96, 64, 32], [1, 2, 4, 8, 16, 1])
    with torch.no_grad():
        feat = flow(torch.randn(1, 6, 5, 243))
        ctx(torch.cat([feat, torch.zeros(1, 6, 5, 2)], -1))
    assert routed == DECODER_CONVS
    assert all(isinstance(m, pyramid2d.DecoderConv)
               for m in [*(getattr(flow, f"conv{i}") for i in range(1, 6)), *ctx.convs])


def test_encoder_and_heads_keep_conv2d(routed):
    pyr = pyramid2d.FeaturePyramid2D([3, 16, 32, 64, 96], norm="batch_norm")
    head = pyramid2d.UpMaskHead2D(32)
    with torch.no_grad():
        pyr.eval()(torch.randn(1, 32, 32, 3))
        head(torch.randn(1, 8, 8, 32))
    assert routed == []
    assert not any(isinstance(m, pyramid2d.DecoderConv) for m in (*pyr.modules(), *head.modules()))


def test_model_routes_eleven_convs_a_level(routed):
    """The small model (2 decode levels): the 11 decoder convs at each level
    go through the wrapper, and a FlopCount records them as its kernel's
    calls."""
    model = RPEFlow(ConfigNode(small_cfg_dict()), N_SAMPLES)
    batch = make_inputs(0)
    with torch.inference_mode(), FlopCount() as count:
        model({k: torch.from_numpy(batch[k]) for k in MODEL_KEYS})
    assert routed == DECODER_CONVS * 2
    assert [shape[3:] for name, shape in count.calls if name == "conv3x3"] == DECODER_CONVS * 2


# -- the parameters and module names ------------------------------------------------


def test_state_dict_and_module_names_unchanged():
    """The port's model has the parameter names, shapes and module names of
    the frozen reference (the benchmark's copy of the parent's plain path),
    so checkpoints and the benchmark's module scopes still find them."""
    cfg = ConfigNode(small_cfg_dict())
    port, ref = RPEFlow(cfg, N_SAMPLES), ReferenceRPEFlow(cfg, N_SAMPLES)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert [n for n, _ in port.named_modules()] == [n for n, _ in ref.named_modules()]
    decoder = [n for n, m in port.named_modules() if isinstance(m, pyramid2d.DecoderConv)]
    assert decoder == [f"pwc_fusion_core.flow_estimator_2d.conv{i}" for i in range(1, 6)] + \
        [f"pwc_fusion_core.context_network_2d.convs.{i}" for i in range(6)]


def test_jax_exported_state_dict_loads_strictly():
    """A JAX model's variables, exported under the upstream names
    (``to_torch_state_dict``, what ``scripts/export_torch_checkpoint.py``
    writes), load into the port with strict=True, the decoder convs' weights
    bitwise."""
    jax_model = JaxRPEFlow(cfgs=JaxConfigNode(small_cfg_dict()), n_samples_list=N_SAMPLES)
    inputs = {k: v for k, v in make_inputs(0).items() if k in MODEL_KEYS}
    shapes = jax.eval_shape(
        lambda x: jax_model.init({"params": jax.random.PRNGKey(0), "mi": jax.random.PRNGKey(1)},
                                 x, train=True, compute_mi=True), inputs)
    exported = to_torch_state_dict(fill_variables(shapes, seed=3))
    port = RPEFlow(ConfigNode(small_cfg_dict()), N_SAMPLES)
    result = port.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in exported.items()},
                                  strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    key = "pwc_fusion_core.context_network_2d.convs.4.conv_fn.weight"
    assert torch.equal(port.state_dict()[key], torch.from_numpy(np.asarray(exported[key])))
