"""The hand-written CUDA kernels against their plain PyTorch versions, and
the whole eval forward on the card against the CPU. Marked ``cuda``: they
skip without a CUDA device. This file imports no JAX, so it also runs on a
machine that has only PyTorch:

    RPEFLOW_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_kernels_cuda.py

(``RPEFLOW_TEST_TPU=1`` keeps tests/conftest.py from setting up JAX.)
Tolerances: FPS indices equal; correlation atol 1e-5; MDTA v atol 1e-5,
qk/sq within 1e-4 of their largest entry; GDFN rtol 1e-4, atol 1e-5.
"""

import pytest
import torch

from rpeflow_tpu_torch.ops import correlation, fps, gdfn, mdta
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
@pytest.mark.parametrize("shape", [(4, 144, 240, 32), (4, 9, 15, 192), (1, 37, 61, 20)])
def test_correlation_kernel_matches_plain(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    f1 = torch.randn(*shape, generator=g, device=cuda_device)
    f2 = torch.randn(*shape, generator=g, device=cuda_device)
    out = correlation.correlation2d(f1, f2, 4)
    torch.testing.assert_close(out, correlation.correlation2d_plain(f1, f2, 4), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kh", [((8, 144, 240, 32), 3), ((4, 9, 15, 192), 3),
                                      ((4, 36, 60, 81), 3), ((8, 1, 4096, 32), 1),
                                      ((4, 1, 256, 192), 1)])
def test_mdta_kernel_matches_plain(cuda_device, shape, kh):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    c = shape[-1]
    x = torch.randn(*shape, generator=g, device=cuda_device)
    y = torch.randn(*shape, generator=g, device=cuda_device)
    ln = 1 + 0.1 * torch.randn(4, c, generator=g, device=cuda_device)
    dw = 0.2 * torch.randn(kh, 3, 3 * c, generator=g, device=cuda_device)
    v, qk, sq = mdta.mdta_qkv(x, y, ln, dw, kh)
    rv, rqk, rsq = mdta.mdta_qkv_plain(x, y, ln, dw, kh)
    torch.testing.assert_close(v, rv, atol=1e-5, rtol=0)
    _assert_sums_close(qk, rqk, "qk")
    _assert_sums_close(sq, rsq, "sq")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 144, 240, 32), (4, 36, 60, 81), (8, 9, 15, 192)])
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
