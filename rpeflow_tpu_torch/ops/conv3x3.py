"""The 2-D decoder's 3x3 convolutions, with autograd: stride 1, dilation d,
zero padding d, bias, channels-last.

``x [B, H, W, Cin]``, ``weight [Cout, Cin, 3, 3]`` (as ``nn.Conv2d``
stores it), ``bias [Cout]`` -> ``[B, H, W, Cout]``. No TPU kernel stands
behind it: the JAX package leaves these convs to XLA. On the card cuDNN's
heuristic sends the widest of them to an FFT algorithm; :func:`conv3x3_fwd`
launches ``csrc/conv3x3.cu`` (a direct f32 implicit GEMM) for CUDA tensors
and runs :func:`conv3x3_plain` for CPU tensors. :func:`conv3x3_nhwc` is
differentiable: its backward is ``aten.convolution_backward`` with the
arguments autograd gives it for :func:`conv3x3_plain`, so a training step's
backward is cuDNN's, as without the kernel.

How a call is cut (the block's tile of pixels by output channels) is
:func:`conv3x3_plan`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _cuda
from ..utils.flops import counted

THREADS = 128
#: taps, and the input tiles' ring (csrc/conv3x3.cu)
TAPS, STAGES = 9, 4
#: (BM pixels, BN output channels, CK input channels a step) of a block, in
#: the plan's order of preference; the last, twice the channels a step, for
#: maps too small to give any other enough blocks
TILES = ((128, 64, 16), (64, 64, 16), (128, 32, 16), (64, 32, 16), (64, 32, 32))
#: blocks an SM runs at once (the kernel's launch bounds and shared memory)
BLOCKS_PER_SM = 2
#: blocks a tile has to give each SM to be taken: the rule nearest the best
#: tile at each of the decoder's 55 shapes of both configurations on an H100
#: (scripts/torch_conv3x3_probe.py --plans)
MIN_BLOCKS_PER_SM = 1.5
SMEM_LIMIT = 232448
INT_LIMIT = 2 ** 31


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                  dilation: int) -> torch.Tensor:
    """``F.conv2d`` on the channels-last view, result channels-last."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, 1, dilation, dilation)
    return out.permute(0, 2, 3, 1)


@dataclass(frozen=True)
class Conv3x3Plan:
    """How ``csrc/conv3x3.cu`` cuts one call: blocks of ``bm`` pixels (of
    the M = B H W) by ``bn`` output channels, the output-channel tile
    fastest; each block walks K = 9 Cin in steps of one tap of a chunk of
    ``ck`` channels, the last chunk zero-filled past Cin."""
    b: int
    h: int
    w: int
    cin: int
    cout: int
    d: int
    bm: int
    bn: int
    ck: int

    @property
    def m(self) -> int:
        return self.b * self.h * self.w

    @property
    def m_tiles(self) -> int:
        return -(-self.m // self.bm)

    @property
    def n_tiles(self) -> int:
        return -(-self.cout // self.bn)

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def chunks(self) -> int:
        return -(-self.cin // self.ck)

    @property
    def tail(self) -> int:
        """Channels of the last chunk (``ck`` where it divides Cin)."""
        return self.cin - self.ck * (self.chunks - 1)

    @property
    def copy_bytes(self) -> int:
        """Bytes of each copy of the input tiles: the widest that every
        pixel row's alignment allows (16 where Cin % 4 == 0, 8 where Cin is
        even, else 4) on a 16-byte aligned input."""
        return 16 if self.cin % 4 == 0 else 8 if self.cin % 2 == 0 else 4

    @property
    def smem_bytes(self) -> int:
        """The input ring (``ck + 4`` floats a pixel), a chunk's weights as
        copied (``9 ck + 4`` floats an output channel), and transposed."""
        ck = self.ck
        return 4 * (STAGES * self.bm * (ck + 4) + self.bn * (TAPS * ck + 4) + TAPS * ck * self.bn)

    @functools.cached_property
    def c_plan(self) -> tuple[ctypes.Array, int]:
        """The plan as the C entry point reads it, an int64 array (B, H, W,
        Cin, Cout, d, BM, BN, CK), and its address."""
        arr = (ctypes.c_longlong * 9)(self.b, self.h, self.w, self.cin, self.cout, self.d,
                                      self.bm, self.bn, self.ck)
        return arr, ctypes.addressof(arr)


def conv3x3_plan(b: int, h: int, w: int, cin: int, cout: int, dilation: int,
                 num_sms: int = 132, tile: tuple[int, int, int] | None = None) -> Conv3x3Plan:
    """The kernel's plan for ``x [b, h, w, cin]`` to ``cout`` channels: the
    first of :data:`TILES` whose BN divides Cout (any, where none does) and
    that gives :data:`MIN_BLOCKS_PER_SM` blocks an SM, else the last tile.
    ``tile`` (one of :data:`TILES`) overrides."""
    if min(b, h, w, cin, dilation) < 1 or cout < 4 or cout % 4:
        raise ValueError(f"conv3x3: shape {(b, h, w, cin)} to {cout}, dilation {dilation}")
    m = b * h * w
    if max(m * cin, m * cout, 9 * cin * cout, (dilation * (w + 1) + m) * cin) >= INT_LIMIT:
        raise ValueError(f"conv3x3: shape {(b, h, w, cin)} to {cout} overflows int32 offsets")
    if tile is None:
        tiles = [t for t in TILES[:-1] if cout % t[1] == 0] or TILES[:-1]
        enough = MIN_BLOCKS_PER_SM * num_sms
        tile = next((t for t in tiles if -(-m // t[0]) * -(-cout // t[1]) >= enough), TILES[-1])
    if tuple(tile) not in TILES:
        raise ValueError(f"conv3x3: no tile {tile}")
    return Conv3x3Plan(b, h, w, cin, cout, dilation, *tile)


@functools.lru_cache(maxsize=512)
def _cached_plan(b: int, h: int, w: int, cin: int, cout: int, dilation: int,
                 device_index: int) -> Conv3x3Plan:
    return conv3x3_plan(b, h, w, cin, cout, dilation, _cuda.sm_count(device_index))


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> None:
    cout = weight.shape[0]
    if (x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[1:]) != (x.shape[-1], 3, 3)
            or (bias is not None and tuple(bias.shape) != (cout,))):
        raise ValueError(f"conv3x3: shapes {tuple(x.shape)}, weight {tuple(weight.shape)}, "
                         f"bias {None if bias is None else tuple(bias.shape)}")


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           plan: Conv3x3Plan) -> torch.Tensor:
    """One launch of ``csrc/conv3x3.cu`` under ``plan``."""
    operands = (x, weight) if bias is None else (x, weight, bias)
    _cuda.require_cuda("conv3x3", *operands)
    if x.shape != (plan.b, plan.h, plan.w, plan.cin) or weight.shape[0] != plan.cout:
        raise ValueError(f"conv3x3: plan for {(plan.b, plan.h, plan.w, plan.cin)} to "
                         f"{plan.cout}; got {tuple(x.shape)}, weight {tuple(weight.shape)}")
    out = x.new_empty(plan.b, plan.h, plan.w, plan.cout)
    with _cuda.on_device(x.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_conv3x3(
            x.data_ptr(), weight.data_ptr(), 0 if bias is None else bias.data_ptr(),
            out.data_ptr(), plan.c_plan[1], stream), "conv3x3")
    _cuda.LAUNCHES["conv3x3"] += 1
    return out


@counted("conv3x3", lambda x, weight, bias, dilation: (*x.shape, weight.shape[0], dilation))
def conv3x3_fwd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                dilation: int) -> torch.Tensor:
    """The forward: one launch of the kernel for CUDA tensors (float32,
    contiguous, else it raises), :func:`conv3x3_plain` for CPU tensors."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, dilation)
    b, h, w, cin = x.shape
    return launch(x, weight, bias,
                  _cached_plan(b, h, w, cin, weight.shape[0], dilation, x.get_device()))


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, dilation):
        ctx.save_for_backward(x, weight)
        ctx.dilation = dilation
        ctx.has_bias = bias is not None
        return conv3x3_fwd(x, weight, bias, dilation)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        d = ctx.dilation
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        gx, gw, gb = torch.ops.aten.convolution_backward(
            g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight,
            [weight.shape[0]] if ctx.has_bias else None, [1, 1], [d, d], [d, d], False,
            [0, 0], 1, [need_x, need_w, need_b and ctx.has_bias])
        return gx.permute(0, 2, 3, 1) if need_x else None, gw, gb, None


def conv3x3_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                 dilation: int = 1) -> torch.Tensor:
    """Differentiable 3x3 conv, stride 1, dilation and zero padding
    ``dilation``, of a channels-last map (the kernel's forward, cuDNN's
    backward)."""
    return _Conv3x3.apply(x, weight, bias, dilation)
