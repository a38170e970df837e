"""The hand-written CUDA kernels against their plain PyTorch versions, and
the whole eval forward on the card against the CPU. Marked ``cuda``: they
skip without a CUDA device. This file imports no JAX, so it also runs on a
machine that has only PyTorch:

    RPEFLOW_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_kernels_cuda.py

(``RPEFLOW_TEST_TPU=1`` keeps tests/conftest.py from setting up JAX.)
Tolerances: FPS indices equal (ties included); correlation atol 1e-5, each
gradient of its fused backward within 1e-5 of its largest entry, two
backward calls bitwise equal; MDTA v atol 1e-5,
qk/sq within 1e-4 of their largest entry, two calls bitwise equal; GDFN rtol 1e-4, atol 1e-5;
depthwise conv and its input gradient atol 1e-5, its taps gradient (a sum
over every pixel) within 1e-4 of its largest entry, two backward calls
bitwise equal; the gathers and the zero store exactly equal (they copy or
store values), the lane gather under other plans too; the decoder's 3x3
conv within 1e-4 of F.conv2d's largest entry (f32, TF32 off; cuDNN's pick
is an FFT at the widest shapes), two calls bitwise equal.
The autograd functions (kernels inside) hold their gradients to
``torch.autograd`` through the plain compositions within 1e-4 of each
gradient's largest entry.
"""

import pytest
import torch

from rpeflow_tpu_torch.ops import (
    _cuda,
    conv3x3,
    correlation,
    dwconv,
    fps,
    gather,
    gdfn,
    mdta,
    zero_store,
)
from chip_smoke import (
    CONV3X3_EDGE_SHAPES,
    CORR_EDGE_PLAN,
    CORR_EDGE_SHAPES,
    DWCONV_EDGE_SHAPES,
    GATHER_EDGE_SHAPES,
    ZERO_EDGE_SHAPES,
    conv3x3_shapes,
    gather_case,
)
from torch_port_utils import MDTA_EDGE_SHAPES, MDTA_FLAGSHIP_SHAPES
from torch_port_utils import cuda_device  # noqa: F401


def _assert_sums_close(out, ref, name):
    rel = float((out.double() - ref.double()).abs().max() / ref.double().abs().max())
    assert rel <= 1e-4, f"{name}: error {rel:.2e} of the largest entry"


@pytest.mark.cuda
def test_fps_kernel_equals_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    xyz = torch.rand(8, 8192, 3, generator=g, device=cuda_device) * 20
    out = fps.furthest_point_sampling(xyz, 4096)
    ref = fps.furthest_point_sampling_plain(xyz, 4096)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,s", [(2, 1000, 1000), (3, 3000, 1500), (4, 8191, 4096),
                                   (1, 5, 5), (1, 1, 1)])
def test_fps_kernel_ties_and_ragged_rows(cuda_device, b, n, s):
    """Duplicated points on an integer grid (exact distance ties), N not a
    multiple of the kernel's 512 threads, n_samples up to N."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    xyz = torch.rand(b, n, 3, generator=g, device=cuda_device) * 20
    idx = torch.randint(0, max(n // 4, 1), (n,), generator=g, device=cuda_device)
    xyz = torch.round(xyz[:, idx])
    _cuda.reset_launch_counts()
    out = fps.furthest_point_sampling(xyz, s)
    assert _cuda.LAUNCHES["fps"] == 1
    assert torch.equal(out, fps.furthest_point_sampling_plain(xyz, s))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 144, 240, 32), (4, 9, 15, 192), (1, 37, 61, 20)])
def test_correlation_kernel_matches_plain(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    f1 = torch.randn(*shape, generator=g, device=cuda_device)
    f2 = torch.randn(*shape, generator=g, device=cuda_device)
    out = correlation.correlation2d(f1, f2, 4)
    torch.testing.assert_close(out, correlation.correlation2d_plain(f1, f2, 4), atol=1e-5, rtol=0)


def _corr_inputs(dev, b, h, w, c, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    f1 = torch.randn(b, h, w, c, generator=g, device=dev)
    f2 = torch.randn(b, h, w, c, generator=g, device=dev)
    return f1, f2, torch.randn(b, h, w, (2 * d + 1) ** 2, generator=g, device=dev)


def _assert_rel_close(out, ref, name, rel=1e-5):
    err = float((out.double() - ref.double()).abs().max() / ref.double().abs().max())
    assert err <= rel, f"{name}: error {err:.2e} of the largest entry"


_CORR_CASES = [(4, 144, 240, 32, 4), (4, 72, 120, 64, 4), (4, 9, 15, 192, 4)] + CORR_EDGE_SHAPES


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [False, True], ids=["plan", "th3-tw32"])
@pytest.mark.parametrize("shape", _CORR_CASES)
def test_correlation_fwd_bwd_match_plain(cuda_device, shape, forced):
    """Flagship and edge shapes (tiles cut by the edge, C = 3, 20, 81, d = 0,
    1, 4, B = 1, one pixel), under the default plans and under
    CORR_EDGE_PLAN: the forward atol 1e-5, each gradient of the fused
    backward within 1e-5 of its largest entry, one launch a wrapper call,
    two backward calls bitwise equal."""
    d = shape[-1]
    f1, f2, g = _corr_inputs(cuda_device, *shape)
    if forced:
        fp, bp = (correlation.correlation_plan(*shape, backward=b, **CORR_EDGE_PLAN)
                  for b in (False, True))
        fwd = lambda: correlation.launch_fwd(f1, f2, fp)  # noqa: E731
        bwd = lambda: correlation.launch_bwd(f1, f2, g, bp)  # noqa: E731
    else:
        fwd = lambda: correlation.correlation2d_fwd(f1, f2, d)  # noqa: E731
        bwd = lambda: correlation.correlation2d_bwd(f1, f2, g, d)  # noqa: E731
    _cuda.reset_launch_counts()
    out, grads = fwd(), bwd()
    assert _cuda.LAUNCHES["correlation2d"] == 1 and _cuda.LAUNCHES["correlation2d_bwd"] == 1
    torch.testing.assert_close(out, correlation.correlation2d_plain(f1, f2, d), atol=1e-5, rtol=0)
    for name, got, ref in zip(("grad1", "grad2"), grads,
                              correlation.correlation2d_bwd_plain(f1, f2, g, d)):
        _assert_rel_close(got, ref, name)
    assert all(torch.equal(a, b) for a, b in zip(grads, bwd()))


@pytest.mark.cuda
def test_correlation_kernel_refuses_what_it_cannot_run(cuda_device):
    f1, f2, g = _corr_inputs(cuda_device, 1, 8, 8, 32, 4)
    bad = correlation.CorrPlan(1, 8, 8, 32, 4, 5, 16, False)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        correlation.launch_fwd(f1, f2, bad)
    with pytest.raises(ValueError, match="max_displacement"):
        correlation.correlation2d_fwd(f1, f2, 5)


_MDTA_CASES = [((8, 144, 240, 32), 3), ((4, 9, 15, 192), 3), ((4, 36, 60, 81), 3),
               ((8, 1, 4096, 32), 1), ((4, 1, 256, 192), 1)]
_MDTA_CASES += [(s[:4], s[4]) for s in MDTA_EDGE_SHAPES if (s[:4], s[4]) not in _MDTA_CASES]


def _mdta_inputs(dev, shape, kh, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = torch.randn(*shape, generator=g, device=dev)
    y = torch.randn(*shape, generator=g, device=dev)
    ln = 1 + 0.1 * torch.randn(4, c, generator=g, device=dev)
    dw = 0.2 * torch.randn(kh, 3, 3 * c, generator=g, device=dev)
    return x, y, ln, dw


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kh", _MDTA_CASES)
def test_mdta_kernel_matches_plain(cuda_device, shape, kh):
    """Flagship shapes, then edge shapes at every width (tiles cut by the
    map's edge, one token, a DSEC level-1 map, ragged point runs, many tiles
    per batch element); one kernel call per wrapper call."""
    x, y, ln, dw = _mdta_inputs(cuda_device, shape, kh)
    _cuda.reset_launch_counts()
    v, qk, sq = mdta.mdta_qkv(x, y, ln, dw, kh)
    assert _cuda.LAUNCHES["mdta_qkv"] == 1
    rv, rqk, rsq = mdta.mdta_qkv_plain(x, y, ln, dw, kh)
    torch.testing.assert_close(v, rv, atol=1e-5, rtol=0)
    _assert_sums_close(qk, rqk, "qk")
    _assert_sums_close(sq, rsq, "sq")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kh", [((4, 144, 240, 96), 3), ((4, 144, 240, 81), 3),
                                      ((8, 9, 15, 192), 3), ((4, 1, 4096, 64), 1)])
def test_mdta_kernel_is_deterministic(cuda_device, shape, kh):
    """Partials summed in block order, no atomics: two calls are bitwise equal."""
    inputs = _mdta_inputs(cuda_device, shape, kh, seed=1)
    first = mdta.mdta_qkv(*inputs, kh)
    second = mdta.mdta_qkv(*inputs, kh)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mdta_plan_matches_kernel(cuda_device):
    """The plan's shared-memory count is the kernel's own, and the kernel
    refuses a plan whose tile does not fit one block."""
    lib = _cuda.lib()
    for shape in MDTA_FLAGSHIP_SHAPES + MDTA_EDGE_SHAPES:
        plan = mdta.mdta_plan(*shape, num_sms=_cuda.sm_count(cuda_device))
        assert lib.rpeflow_mdta_smem_bytes(plan.c, plan.kh, plan.th, plan.tw) == plan.smem_bytes
    x, y, ln, dw = _mdta_inputs(cuda_device, (1, 8, 64, 192), 3)
    too_big = mdta.mdta_plan(1, 8, 64, 192, 3, tile=(8, 64, 64))
    assert too_big.smem_bytes > mdta.SMEM_PER_BLOCK
    with pytest.raises(RuntimeError, match="cudaError 1"):
        mdta.launch_qkv(x, y, ln, dw, too_big)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 144, 240, 32), (4, 36, 60, 81), (8, 9, 15, 192),
                                   (4, 72, 120, 96), (8, 18, 30, 128)])
def test_gdfn_kernel_matches_plain(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    c = shape[-1]
    hidden = int(c * 2.66)
    x = torch.randn(*shape, generator=g, device=cuda_device)
    w_in = torch.randn(c, 2 * hidden, generator=g, device=cuda_device) / c ** 0.5
    w_dw = torch.randn(3, 3, 2 * hidden, generator=g, device=cuda_device) / 3
    w_out = torch.randn(hidden, c, generator=g, device=cuda_device) / hidden ** 0.5
    torch.testing.assert_close(gdfn.gdfn(x, w_in, w_dw, w_out),
                               gdfn.gdfn_plain(x, w_in, w_dw, w_out), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64, 81, 96, 128, 192])
@pytest.mark.parametrize("b,h,w", [(1, 7, 15), (1, 13, 30), (1, 9, 60), (1, 1, 1),
                                   (4, 120, 160), (8, 100, 130)])
def test_gdfn_kernel_ragged_tiles(cuda_device, c, b, h, w):
    """Tiles cut by the image edge (30-column tiles; H not a multiple of the
    6- or 2-row tile), every channel class; one launch per call. B = 1 maps
    take 2-row tiles; the larger ones (a DSEC level-1 map is 120 x 160) take
    6-row tiles up to 96 channels."""
    assert gdfn.tile_rows(b, h, w, c) == (6 if b > 1 and c <= 96 else 2)
    g = torch.Generator(device=cuda_device).manual_seed(c + h)
    hidden = int(c * 2.66)
    x = torch.randn(b, h, w, c, generator=g, device=cuda_device)
    w_in = torch.randn(c, 2 * hidden, generator=g, device=cuda_device) / c ** 0.5
    w_dw = torch.randn(3, 3, 2 * hidden, generator=g, device=cuda_device) / 3
    w_out = torch.randn(hidden, c, generator=g, device=cuda_device) / hidden ** 0.5
    _cuda.reset_launch_counts()
    out = gdfn.gdfn_fwd(x, w_in, w_dw, w_out)
    assert _cuda.LAUNCHES["gdfn"] == 1
    torch.testing.assert_close(out, gdfn.gdfn_plain(x, w_in, w_dw, w_out), rtol=1e-4, atol=1e-5)


_DWCONV_CASES = [((4, 144, 240, 32), 3), ((4, 144, 240, 510), 3), ((4, 72, 120, 340), 3),
                 ((4, 9, 15, 1020), 3), ((4, 36, 60, 81), 3), ((8, 1, 4096, 170), 1),
                 ((1, 7, 5, 3), 3)]
_DWCONV_CASES += [(s[:4], s[4]) for s in DWCONV_EDGE_SHAPES]


def _dwconv_inputs(dev, shape, kh, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(*shape, generator=g, device=dev)
    taps = torch.randn(kh, 3, shape[-1], generator=g, device=dev) / 3
    return x, torch.randn(*shape, generator=g, device=dev), taps


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kh", _DWCONV_CASES)
def test_dwconv_kernel_matches_plain(cuda_device, shape, kh):
    """Training-step and edge shapes (tiles, strips and channel blocks cut by
    the edge, W = 1, H = 1, C = 3 to 1020, ragged point runs, a batch beyond
    one wave of blocks): the forward and the fused backward, one launch per
    wrapper call, also with only one of the two gradients."""
    x, gout, taps = _dwconv_inputs(cuda_device, shape, kh)
    _cuda.reset_launch_counts()
    out = dwconv.dwconv_fwd(x, taps)
    dx, dtaps = dwconv.dwconv_bwd(x, gout, taps)
    assert _cuda.LAUNCHES["dwconv"] == 2
    ref_dx, ref_dtaps = dwconv.dwconv_bwd_plain(x, gout, taps)
    torch.testing.assert_close(out, dwconv.dwconv_plain(x, taps), atol=1e-5, rtol=0)
    torch.testing.assert_close(dx, ref_dx, atol=1e-5, rtol=0)
    _assert_sums_close(dtaps, ref_dtaps, "dtaps")
    fwd = dwconv.dwconv_plan(*shape, kh, _cuda.sm_count(cuda_device), rh=7)
    torch.testing.assert_close(dwconv.launch_fwd(x, taps, fwd), out, atol=1e-5, rtol=0)
    _cuda.reset_launch_counts()
    only_dx, none = dwconv.dwconv_bwd(x, gout, taps, need_dtaps=False)
    none2, only_dtaps = dwconv.dwconv_bwd(x, gout, taps, need_dx=False)
    assert none is None and none2 is None and _cuda.LAUNCHES["dwconv"] == 2
    assert torch.equal(only_dx, dx) and torch.equal(only_dtaps, dtaps)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kh", [((4, 144, 240, 510), 3), ((4, 72, 120, 96), 3),
                                      ((600, 4, 40, 64), 3), ((4, 1, 4096, 32), 1)])
@pytest.mark.parametrize("forced", [False, True], ids=["plan", "rh7-nb5"])
def test_dwconv_bwd_is_deterministic(cuda_device, shape, kh, forced):
    """Per-block partials summed in a fixed order, no float atomics: two
    backward calls are bitwise equal, under the default plan and under
    7-row strips and 5 blocks (which also must stay right)."""
    x, gout, taps = _dwconv_inputs(cuda_device, shape, kh, seed=1)
    if forced:
        plan = dwconv.dwconv_plan(*shape, kh, _cuda.sm_count(cuda_device), backward=True,
                                  rh=7, nb=5)
        call = lambda: dwconv.launch_bwd(x, gout, taps, plan)  # noqa: E731
    else:
        call = lambda: dwconv.dwconv_bwd(x, gout, taps)  # noqa: E731
    first, second = call(), call()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    ref_dx, ref_dtaps = dwconv.dwconv_bwd_plain(x, gout, taps)
    torch.testing.assert_close(first[0], ref_dx, atol=1e-5, rtol=0)
    _assert_sums_close(first[1], ref_dtaps, "dtaps")


def _grads(fn, inputs, gout):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    fn(*leaves).backward(gout)
    return [t.grad for t in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dwconv", "correlation2d", "gdfn", "mdta", "mdta_points"])
def test_autograd_functions_match_plain_autograd(cuda_device, name):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device)  # noqa: E731
    if name == "dwconv":
        inputs = [rnd(4, 36, 60, 96), rnd(3, 3, 96) / 3]
        fn, ref = dwconv.dwconv, dwconv.dwconv_plain
    elif name == "correlation2d":
        inputs = [rnd(4, 36, 60, 64), rnd(4, 36, 60, 64)]
        fn = lambda a, b: correlation.correlation2d(a, b, 4)  # noqa: E731
        ref = lambda a, b: correlation.correlation2d_plain(a, b, 4)  # noqa: E731
    elif name == "gdfn":
        c, h = 64, int(64 * 2.66)
        inputs = [rnd(4, 36, 60, c), rnd(c, 2 * h) / c ** 0.5, rnd(3, 3, 2 * h) / 3,
                  rnd(h, c) / h ** 0.5]
        fn, ref = gdfn.gdfn, gdfn.gdfn_plain
    else:
        shape, kh = ((4, 36, 60, 64), 3) if name == "mdta" else ((4, 1, 1024, 64), 1)
        c = shape[-1]
        inputs = [rnd(*shape), rnd(*shape),
                  torch.stack([1 + 0.1 * rnd(c), 0.1 * rnd(c), 1 + 0.1 * rnd(c), 0.1 * rnd(c)]),
                  0.3 * rnd(kh, 3, 3 * c), 1 + 0.1 * rnd(2, 1, 1), rnd(c, c) / c ** 0.5]
        fn = lambda *a: mdta.mdta_attention(*a, kh, 2)  # noqa: E731
        ref = lambda *a: mdta.mdta_attention_plain(*a, kh, 2)  # noqa: E731
    gout = rnd(*fn(*inputs).shape)
    for got, want in zip(_grads(fn, inputs, gout), _grads(ref, inputs, gout)):
        _assert_sums_close(got, want, name)


@pytest.mark.cuda
def test_eval_forward_card_matches_cpu(cuda_device):
    """Full-depth model at batch 1, 128x192, 2048 points: card (kernels) vs
    CPU (plain versions), tolerance model of tests/test_wrapper_parity.py."""
    from types import SimpleNamespace as NS

    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from torch_port_utils import assert_flow_close, make_inputs, small_cfg_dict

    def ns(d):
        return NS(**{k: ns(v) if isinstance(v, dict) else v for k, v in d.items()})

    cfg = ns(small_cfg_dict(k=16, event_bins=10))
    model = seeded_init_(RPEFlow(cfg, (1024, 512, 256, 128, 64)), seed=0)
    batch = {k: torch.from_numpy(v) for k, v in
             make_inputs(0, b=1, h=128, w=192, n=2048, event_ch=20).items()}
    with torch.inference_mode():
        ref = model(batch)
        out = model.to(cuda_device)({k: v.to(cuda_device) for k, v in batch.items()})
    for key in ("flow_2d", "flow_3d"):
        assert torch.isfinite(out[key]).all()
        assert_flow_close(out[key].cpu().numpy(), ref[key].numpy(), key)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4, 8192, 131072, 128, torch.float32, torch.int32, "random")]
                         + GATHER_EDGE_SHAPES, ids=str)
def test_gathers_equal_plain(cuda_device, case):
    before = dict(_cuda.LAUNCHES)
    gather_case(*case, torch.Generator(device=cuda_device).manual_seed(0))
    assert _cuda.LAUNCHES["gather_rows"] == before["gather_rows"] + 1
    assert _cuda.LAUNCHES["gather_lanes"] == before["gather_lanes"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(1, 256, 1), (2, 1024, 3), (7, 512, 2), (4, 32, 40), (0, 256, 1)],
                         ids=str)
@pytest.mark.parametrize("dtype,idx_dtype,m", [(torch.float32, torch.int32, 8192),
                                               (torch.bfloat16, torch.int64, 8191)], ids=str)
def test_gather_lanes_plans_equal_plain(cuda_device, plan, dtype, idx_dtype, m):
    """The lane gather under plans other than its own (channel groups of 1,
    2 and 7 rows, 32 to 1024 threads, M split; g = 0 the L2 branch): one
    launch, equal to the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    table = torch.randn(2, 13, 8192, generator=g, device=cuda_device).to(dtype)
    idx = torch.randint(0, 8192, (2, m), generator=g, device=cuda_device).to(idx_dtype)
    before = _cuda.LAUNCHES["gather_lanes"]
    got = gather.launch_lanes(table, idx, gather.LanesPlan(*plan))
    assert _cuda.LAUNCHES["gather_lanes"] == before + 1
    assert torch.equal(got, gather.gather_lanes_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile_h", [((2, 144, 240, 256), 8)] + ZERO_EDGE_SHAPES, ids=str)
def test_zero_store_equals_plain(cuda_device, shape, tile_h):
    x = torch.randn(*shape, device=cuda_device)
    got = zero_store.zero_store(x, tile_h)
    assert torch.equal(got, zero_store.zero_store_plain(x, tile_h))
    with pytest.raises(ValueError):
        zero_store.zero_store(x, shape[1] + 1)


#: the decoder conv's shapes at level 1 and level 5 of both configurations'
#: frames (FT3D: batch 4, 576x960 inside; DSEC: batch 3, 512x640)
_CONV3X3_CASES = [s for b, h, w in ((4, 576, 960), (3, 512, 640))
                  for s in conv3x3_shapes(b, h, w) if s[1] in (h >> 2, h >> 6)]


def _conv3x3_inputs(dev, shape, seed=0):
    b, h, w, cin, cout, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=g, device=dev)
    weight = torch.randn(cout, cin, 3, 3, generator=g, device=dev) / (9 * cin) ** 0.5
    return x, weight, 0.1 * torch.randn(cout, generator=g, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", _CONV3X3_CASES + CONV3X3_EDGE_SHAPES, ids=str)
def test_conv3x3_kernel_matches_plain(cuda_device, shape):
    """One launch a call, within 1e-4 of F.conv2d's largest entry, and two
    calls bitwise equal (no atomics, no split of K)."""
    x, weight, bias = _conv3x3_inputs(cuda_device, shape)
    d = shape[5]
    before = _cuda.LAUNCHES["conv3x3"]
    out = conv3x3.conv3x3_fwd(x, weight, bias, d)
    assert _cuda.LAUNCHES["conv3x3"] - before == 1
    _assert_sums_close(out, conv3x3.conv3x3_plain(x, weight, bias, d), f"conv3x3 {shape}")
    assert torch.equal(out, conv3x3.conv3x3_fwd(x, weight, bias, d))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", conv3x3.TILES, ids=str)
@pytest.mark.parametrize("shape", CONV3X3_EDGE_SHAPES + [(4, 9, 15, 243, 192, 1)], ids=str)
def test_conv3x3_every_tile_matches_plain(cuda_device, shape, tile):
    x, weight, bias = _conv3x3_inputs(cuda_device, shape, seed=1)
    plan = conv3x3.conv3x3_plan(*shape, tile=tile)
    out = conv3x3.launch(x, weight, bias, plan)
    _assert_sums_close(out, conv3x3.conv3x3_plain(x, weight, bias, shape[5]),
                       f"conv3x3 {shape} {tile}")


@pytest.mark.cuda
def test_conv3x3_plan_matches_kernel(cuda_device):
    """The plan's shared memory is the kernel's own count, and the card
    holds BLOCKS_PER_SM blocks of every tile on an SM at once."""
    for tile in conv3x3.TILES:
        plan = conv3x3.conv3x3_plan(4, 144, 240, 243, 192, 1, tile=tile)
        assert _cuda.lib().rpeflow_conv3x3_smem_bytes(*tile) == plan.smem_bytes
        assert conv3x3.BLOCKS_PER_SM * plan.smem_bytes <= conv3x3.SMEM_LIMIT
        assert _cuda.lib().rpeflow_conv3x3_blocks_per_sm(*tile) >= conv3x3.BLOCKS_PER_SM


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 36, 60, 243, 192, 1), (2, 36, 60, 98, 128, 1),
                                   (2, 36, 60, 96, 64, 16)], ids=str)
def test_conv3x3_gradients_match_conv2d(cuda_device, shape):
    """The Function's gradients are those of F.conv2d (the same
    convolution_backward call), within 1e-4 of each one's largest entry."""
    x, weight, bias = _conv3x3_inputs(cuda_device, shape, seed=2)
    d = shape[5]
    gout = torch.randn(*shape[:3], shape[4], device=cuda_device)
    got = _grads(lambda a, w_, b_: conv3x3.conv3x3_nhwc(a, w_, b_, d), (x, weight, bias), gout)
    want = _grads(lambda a, w_, b_: conv3x3.conv3x3_plain(a, w_, b_, d), (x, weight, bias), gout)
    for name, a, b in zip(("x", "weight", "bias"), got, want):
        _assert_sums_close(a, b, f"conv3x3 {shape} gradient of {name}")


@pytest.mark.cuda
def test_conv3x3_refuses_what_it_cannot_run(cuda_device):
    x, weight, bias = _conv3x3_inputs(cuda_device, (1, 8, 8, 32, 16, 1))
    with pytest.raises(ValueError):  # not contiguous
        conv3x3.conv3x3_fwd(x.transpose(1, 2), weight, bias, 1)
    with pytest.raises(TypeError):  # not float32
        conv3x3.conv3x3_fwd(x.double(), weight.double(), bias.double(), 1)
    with pytest.raises(TypeError):
        conv3x3.conv3x3_fwd(x.half(), weight, bias, 1)
    with pytest.raises(ValueError):  # Cout not a multiple of 4
        conv3x3.conv3x3_fwd(x, weight[:6], bias[:6], 1)
    with pytest.raises(ValueError):  # weight of another Cin
        conv3x3.conv3x3_fwd(x, weight[:, :16], bias, 1)
