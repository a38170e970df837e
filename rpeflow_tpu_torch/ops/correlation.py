"""Local 2-D cost volume (counterpart of rpeflow_tpu/ops/correlation.py and
the Pallas kernel rpeflow_tpu/ops/pallas/correlation.py), with autograd.

For every pixel, the mean over channels of ``f1(y, x) . f2(y+dy, x+dx)`` for
all ``|dy|, |dx| <= d``, zero outside the frame; output channel
``(dy+d)(2d+1) + (dx+d)``. The JAX package uses its kernel only on maps of
at least 2048 pixels; the port uses it at every decode level.

:func:`correlation2d` is differentiable, both ways through
``csrc/correlation.cu`` (K2):

* forward (:func:`correlation2d_fwd`): one launch;
* backward (:func:`correlation2d_bwd`): one launch that writes both input
  gradients, each a gather (the function of
  ``rpeflow_tpu/ops/correlation.py : _correlation2d_bwd_ref``, which the JAX
  package computes in XLA).

How a call is cut (tile rows and columns) is :func:`correlation_plan`.
The wrappers launch the kernel for CUDA tensors and run the plain versions
(:func:`correlation2d_plain`, :func:`correlation2d_bwd_plain`) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _cuda
from ..utils.flops import counted

#: channels a shared-memory stage holds per pixel, adjacent pixels a thread
#: owns, and the kernel's limits (csrc/correlation.cu)
CHUNK = 32
PIXELS_PER_THREAD = 4
MAX_D = 4
MAX_TH = 4
MAX_THREADS = 288
SMEM_LIMIT = 232448
TILE_WIDTHS = (16, 32)


def correlation2d_plain(f1: torch.Tensor, f2: torch.Tensor,
                        max_displacement: int) -> torch.Tensor:
    """Shifted-multiply form of ``correlation2d_ref``: ``[B,H,W,C]`` x2 ->
    ``[B,H,W,(2d+1)^2]``."""
    d = max_displacement
    _, h, w, _ = f1.shape
    f2p = F.pad(f2, (0, 0, d, d, d, d))
    outs = [(f1 * f2p[:, i:i + h, j:j + w]).mean(-1)
            for i in range(2 * d + 1) for j in range(2 * d + 1)]
    return torch.stack(outs, dim=-1)


def correlation2d_bwd_plain(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                            max_displacement: int):
    """Gradients of the cost volume for ``f1`` and ``f2`` given ``g``:
    ``d corr[ch(i,j)] / d f1 = shift(f2, i, j) / C``, and each ``g_ij * f1 / C``
    lands on ``f2`` at the pixel it was multiplied with (accumulated in a
    d-padded buffer, then cropped)."""
    d = max_displacement
    _, h, w, c = f1.shape
    side = 2 * d + 1
    f2p = F.pad(f2, (0, 0, d, d, d, d))
    grad1 = torch.zeros_like(f1)
    grad2p = torch.zeros_like(f2p)
    for i in range(side):
        for j in range(side):
            gc = g[..., i * side + j, None] / c
            grad1 += gc * f2p[:, i:i + h, j:j + w]
            grad2p[:, i:i + h, j:j + w] += gc * f1
    return grad1, grad2p[:, d:d + h, d:d + w]


@dataclass(frozen=True)
class CorrPlan:
    """How ``csrc/correlation.cu`` cuts one call: blocks of ``th`` output
    rows by ``tw`` columns, channels staged ``CHUNK`` at a time in shared
    memory. The forward's block is (``th`` rows,
    ``2d + 1`` displacement rows, ``tw / 4`` pixel groups) threads; the
    backward's is (``th`` rows, ``tw / 4`` pixel groups, 8 channel groups)
    threads, and it has a block for each gradient."""
    b: int
    h: int
    w: int
    c: int
    d: int
    th: int
    tw: int
    backward: bool

    @property
    def k(self) -> int:
        return (2 * self.d + 1) ** 2

    @property
    def threads(self) -> int:
        groups = self.tw // PIXELS_PER_THREAD
        return self.th * groups * (8 if self.backward else 2 * self.d + 1)

    @property
    def grid(self) -> tuple[int, int, int]:
        return (-(-self.w // self.tw), -(-self.h // self.th),
                2 * self.b if self.backward else self.b)

    @property
    def halo_floats(self) -> int:
        """The staged window of ``f2`` (the backward's ``F``): the tile with
        ``d`` rows and columns on each side, ``CHUNK`` channels a pixel."""
        return (self.th + 2 * self.d) * (self.tw + 2 * self.d) * CHUNK

    @property
    def smem_bytes(self) -> int:
        """Forward: the stage (f1 tile and f2 window) or the output tile,
        whichever is larger; backward: the A tile and the stage."""
        tile = self.th * self.tw
        if self.backward:
            return 4 * (tile * self.k + self.halo_floats)
        return 4 * max(tile * CHUNK + self.halo_floats, tile * self.k)

    def fits(self) -> bool:
        """What the kernel runs (csrc/correlation.cu : plan_ok)."""
        return (min(self.b, self.h, self.w, self.c) >= 1 and 0 <= self.d <= MAX_D
                and self.tw in TILE_WIDTHS and 1 <= self.th <= MAX_TH
                and self.threads <= MAX_THREADS
                and self.grid[1] <= 65535 and self.grid[2] <= 65535
                and self.smem_bytes <= SMEM_LIMIT)

    @functools.cached_property
    def c_plan(self) -> tuple[ctypes.Array, int]:
        """The plan as the C entry points read it, an int64 array (B, H, W,
        C, d, TH, TW), and its address."""
        arr = (ctypes.c_longlong * 7)(self.b, self.h, self.w, self.c, self.d, self.th,
                                      self.tw)
        return arr, ctypes.addressof(arr)


def correlation_plan(b: int, h: int, w: int, c: int, d: int, backward: bool = False,
                     th: int | None = None, tw: int | None = None) -> CorrPlan:
    """The kernel's plan for ``f1, f2 [b, h, w, c]`` at displacement ``d``:
    4-row, 16-column tiles, of the six tiles tried the fastest or within 2 µs
    of it at each of the five decode levels, both ways, on one H100
    (``scripts/torch_corr_probe.py --plans``; PERF.md §6). ``th`` and
    ``tw`` override; a plan the kernel cannot run raises."""
    if not 0 <= d <= MAX_D:
        raise ValueError(f"correlation2d: the kernel takes max_displacement <= {MAX_D}, got {d}")
    plan = CorrPlan(b, h, w, c, d, th or MAX_TH, tw or 16, backward)
    if not plan.fits():
        raise ValueError(f"correlation2d: no kernel plan {plan}")
    return plan


_cached_plan = functools.lru_cache(maxsize=256)(correlation_plan)


def _check(name: str, f1: torch.Tensor, f2: torch.Tensor) -> None:
    if f1.shape != f2.shape or f1.dim() != 4:
        raise ValueError(f"{name}: shapes {tuple(f1.shape)}, {tuple(f2.shape)}")


def _check_plan(name: str, plan: CorrPlan, f1: torch.Tensor, backward: bool) -> None:
    if f1.shape != (plan.b, plan.h, plan.w, plan.c) or plan.backward != backward:
        raise ValueError(f"{name}: plan for {(plan.b, plan.h, plan.w, plan.c)}, "
                         f"backward={plan.backward}; got {tuple(f1.shape)}")


def launch_fwd(f1: torch.Tensor, f2: torch.Tensor, plan: CorrPlan) -> torch.Tensor:
    """One forward launch of ``csrc/correlation.cu`` under ``plan``."""
    _cuda.require_cuda("correlation2d", f1, f2)
    _check("correlation2d", f1, f2)
    _check_plan("correlation2d", plan, f1, backward=False)
    out = torch.empty(*f1.shape[:3], plan.k, dtype=torch.float32, device=f1.device)
    with _cuda.on_device(f1.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_correlation2d(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), plan.c_plan[1], stream),
            "correlation2d")
    _cuda.LAUNCHES["correlation2d"] += 1
    return out


@counted("correlation2d",
         lambda f1, f2, max_displacement: (*f1.shape, max_displacement))
def correlation2d_fwd(f1: torch.Tensor, f2: torch.Tensor,
                      max_displacement: int) -> torch.Tensor:
    """Cost volume ``[B, H, W, (2d+1)^2]`` of float32 ``f1, f2 [B, H, W, C]``
    (the K2 kernel for CUDA tensors, records no gradient)."""
    _check("correlation2d", f1, f2)
    if f1.device.type == "cpu":
        return correlation2d_plain(f1, f2, max_displacement)
    return launch_fwd(f1, f2, _cached_plan(*f1.shape, max_displacement))


def launch_bwd(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor, plan: CorrPlan):
    """One backward launch of ``csrc/correlation.cu`` under ``plan``:
    ``(grad1, grad2)``, views of one allocation."""
    _cuda.require_cuda("correlation2d_bwd", f1, f2, g)
    _check("correlation2d_bwd", f1, f2)
    _check_plan("correlation2d_bwd", plan, f1, backward=True)
    if g.shape != (*f1.shape[:3], plan.k):
        raise ValueError(f"correlation2d_bwd: g {tuple(g.shape)} for {tuple(f1.shape)}, "
                         f"d={plan.d}")
    n = f1.numel()
    buf = torch.empty(2 * n, dtype=torch.float32, device=f1.device)
    grad1, grad2 = buf[:n].view(f1.shape), buf[n:].view(f1.shape)
    with _cuda.on_device(f1.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_correlation2d_bwd(
            f1.data_ptr(), f2.data_ptr(), g.data_ptr(), grad1.data_ptr(), grad2.data_ptr(),
            plan.c_plan[1], stream), "correlation2d_bwd")
    _cuda.LAUNCHES["correlation2d_bwd"] += 1
    return grad1, grad2


@counted("correlation2d_bwd",
         lambda f1, f2, g, max_displacement: (*f1.shape, max_displacement))
def correlation2d_bwd(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                      max_displacement: int):
    """``(grad1, grad2)`` of the cost volume for the output gradient ``g``:
    one K2 backward launch for CUDA tensors, :func:`correlation2d_bwd_plain`
    for CPU tensors."""
    _check("correlation2d_bwd", f1, f2)
    if f1.device.type == "cpu":
        return correlation2d_bwd_plain(f1, f2, g, max_displacement)
    return launch_bwd(f1, f2, g, _cached_plan(*f1.shape, max_displacement, True))


class _Correlation2D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, max_displacement):
        f1, f2 = f1.contiguous(), f2.contiguous()
        ctx.save_for_backward(f1, f2)
        ctx.max_displacement = max_displacement
        return correlation2d_fwd(f1, f2, max_displacement)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        grad1, grad2 = correlation2d_bwd(f1, f2, g.contiguous(), ctx.max_displacement)
        return grad1, grad2, None


def correlation2d(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int) -> torch.Tensor:
    """Differentiable cost volume (K2 forward and fused backward)."""
    return _Correlation2D.apply(f1, f2, max_displacement)
