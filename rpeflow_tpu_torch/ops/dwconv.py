"""Depthwise ``kh x 3`` convolution with autograd (counterpart of the Pallas
kernel rpeflow_tpu/ops/pallas/dwconv.py and of its oracle
``rpeflow_tpu/nn/mdta.py : _dw_flat``).

``x [B, H, W, C]``, ``taps [kh, 3, C]`` -> ``[B, H, W, C]``: zero padding,
no bias, channels-last; ``kh`` is 3 for 2-D maps and 1 for point maps
``[B, 1, N, C]``. :func:`dwconv` is differentiable, both ways through the
``csrc/dwconv.cu`` kernel (K5):

* forward (:func:`dwconv_fwd`): one launch;
* backward (:func:`dwconv_bwd`): one call that makes one pass over the
  output gradient ``g`` and writes the input gradient (the same conv of
  ``g`` with the taps rotated by 180 degrees, read rotated by index) and
  the taps gradient ``sum_{b,y,x} g * shift(x)`` (per-block partials, summed
  in a fixed order by a second launch); either one can be left out.

How a call is cut (vector width, block, rows per thread, backward blocks)
is :func:`dwconv_plan`. The wrappers launch the kernel for CUDA tensors and
run the plain versions (:func:`dwconv_plain`, :func:`dwconv_bwd_plain`) for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from . import _cuda
from ..utils.flops import counted

THREADS = 256
#: shared-memory ring stages at one column a thread (half at two), and the
#: launch's limit (csrc/dwconv.cu)
STAGES = 8
SMEM_LIMIT = 48 * 1024
#: fewest and most rows a thread walks down a strip of a 2-D map
MIN_ROWS, MAX_ROWS = 8, 32
#: units each block should walk, so that uneven shares cost little
UNITS_PER_BLOCK = 4
#: blocks an SM runs at once: what the kernel's launch bounds hold its
#: registers to (csrc/dwconv.cu : kBlocksPerSm)
BLOCKS_PER_SM = 2


def cols_per_thread(v: int, backward: bool) -> int:
    """Adjacent columns a thread takes (csrc/dwconv.cu : cols_per_thread):
    two, except one for the forward at 4 channels, whose registers spill
    at two."""
    return 1 if v == 4 and not backward else 2


def dwconv_plain(z: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise ``kh x 3`` conv through ``F.conv2d`` (groups = C)."""
    kh, _, c = taps.shape
    weight = taps.permute(2, 0, 1).unsqueeze(1)  # [C, 1, kh, 3]
    out = F.conv2d(z.permute(0, 3, 1, 2), weight, padding=(kh // 2, 1), groups=c)
    return out.permute(0, 2, 3, 1)


def dwconv_bwd_plain(x: torch.Tensor, g: torch.Tensor, taps: torch.Tensor,
                     need_dx: bool = True, need_dtaps: bool = True):
    """``(dx, dtaps)`` of :func:`dwconv_plain` at ``x`` for the output
    gradient ``g`` (None where not needed): ``dx`` the conv of ``g`` with the
    taps rotated by 180 degrees, ``dtaps[i, j] = sum_{b,y,x} g[b,y,x] *
    x[b, y+i-kh//2, x+j-1]``."""
    kh = taps.shape[0]
    dx = dwconv_plain(g, taps.flip(0, 1)) if need_dx else None
    dtaps = None
    if need_dtaps:
        _, h, w, _ = x.shape
        ph = kh // 2
        xp = F.pad(x, (0, 0, 1, 1, ph, ph))
        dtaps = torch.stack([(g * xp[:, i:i + h, j:j + w]).sum((0, 1, 2))
                             for i in range(kh) for j in range(3)]).reshape(kh, 3, -1)
    return dx, dtaps


@dataclass(frozen=True)
class DwPlan:
    """How ``csrc/dwconv.cu`` cuts one call: a thread takes ``v`` channels of
    ``tx`` adjacent columns; a block is ``cgb`` channel groups by ``cols``
    columns (``cgb * cols / tx`` threads); the ``nb`` blocks of each channel
    block walk the units (batch element, strip of ``rh`` rows, column tile),
    block ``k`` taking units ``k, k + nb, ...``."""
    b: int
    h: int
    w: int
    c: int
    kh: int
    v: int
    cgb: int
    cols: int
    rh: int
    nb: int
    tx: int
    backward: bool

    @property
    def ch_blocks(self) -> int:
        return -(-(self.c // self.v) // self.cgb)

    @property
    def col_tiles(self) -> int:
        return -(-self.w // self.cols)

    @property
    def strips(self) -> int:
        return -(-self.h // self.rh)

    @property
    def units(self) -> int:
        return self.b * self.strips * self.col_tiles

    @property
    def scratch_floats(self) -> int:
        """The backward's per-block partials of the taps gradient."""
        return self.nb * self.kh * 3 * self.c if self.backward else 0

    @property
    def smem_bytes(self) -> int:
        """The ring (a tile row with its halo columns, and x's tile row in the
        backward, per stage) or the backward's block sum, whichever is larger."""
        tch = self.cgb * self.v
        ring = STAGES // self.tx * (self.cols + 2 + (self.cols if self.backward else 0)) * tch
        sums = self.cols * tch * self.kh * 3 if self.backward else 0
        return 4 * max(ring, sums)

    @functools.cached_property
    def c_plan(self) -> tuple[ctypes.Array, int]:
        """The plan as the C entry points read it, an int64 array (B, H, W,
        C, kh, v, cgb, cols, rh, nb, tx), and its address."""
        arr = (ctypes.c_longlong * 11)(self.b, self.h, self.w, self.c, self.kh, self.v,
                                       self.cgb, self.cols, self.rh, self.nb, self.tx)
        return arr, ctypes.addressof(arr)


def dwconv_plan(b: int, h: int, w: int, c: int, kh: int, num_sms: int = 132,
                backward: bool = False, v: int | None = None, rh: int | None = None,
                nb: int | None = None) -> DwPlan:
    """The kernel's plan for ``x [b, h, w, c]``: the widest vector of 4, 2, 1
    channels that divides C (at most 2 in the backward, whose window, taps
    and sums all sit in registers; the kernel has no 4-wide backward),
    :func:`cols_per_thread` columns a thread, up to 32 channel groups by as
    many columns as fill 256 threads, as many blocks as the card runs at
    once, and rows per thread (``MIN_ROWS`` to ``MAX_ROWS`` on 2-D maps, cut
    into equal strips) that give each block about ``UNITS_PER_BLOCK``
    units. ``v``, ``rh`` and ``nb`` override."""
    if kh not in (1, 3) or min(b, h, w, c) < 1:
        raise ValueError(f"dwconv: shape {(b, h, w, c)}, kh={kh}")
    if v is None:
        v = next(k for k in ((2, 1) if backward else (4, 2, 1)) if c % k == 0)
    if c % v or v not in ((1, 2) if backward else (1, 2, 4)):
        raise ValueError(f"dwconv: {v} channels a thread at C = {c}, backward={backward}")
    tx = cols_per_thread(v, backward)
    cgb = min(c // v, 32)
    plan = DwPlan(b, h, w, c, kh, v, cgb, tx * (THREADS // cgb), 1, 1, tx, backward)
    blocks = max(1, num_sms * BLOCKS_PER_SM // plan.ch_blocks)
    if rh is None:
        rh = b * h * plan.col_tiles // (UNITS_PER_BLOCK * blocks)
        rh = max(MIN_ROWS, min(MAX_ROWS, rh))
    rh = min(rh, h)
    plan = replace(plan, rh=-(-h // -(-h // rh)))  # equal strips
    return replace(plan, nb=nb or min(plan.units, blocks))


@functools.lru_cache(maxsize=512)
def _cached_plan(b: int, h: int, w: int, c: int, kh: int, device_index: int,
                 backward: bool) -> DwPlan:
    return dwconv_plan(b, h, w, c, kh, _cuda.sm_count(device_index), backward)


def _check(name: str, x: torch.Tensor, kh: int, c: int) -> None:
    if x.dim() != 4 or x.shape[-1] != c or kh not in (1, 3):
        raise ValueError(f"{name}: shapes {tuple(x.shape)}, kh={kh}, C={c}")


def _check_plan(name: str, plan: DwPlan, x: torch.Tensor, taps: torch.Tensor,
                backward: bool) -> None:
    if x.shape != (plan.b, plan.h, plan.w, plan.c) or taps.shape != (plan.kh, 3, plan.c) \
            or plan.backward != backward:
        raise ValueError(f"{name}: plan for {(plan.b, plan.h, plan.w, plan.c)}, kh={plan.kh}, "
                         f"backward={plan.backward}; got {tuple(x.shape)}, "
                         f"taps {tuple(taps.shape)}")


def launch_fwd(x: torch.Tensor, taps: torch.Tensor, plan: DwPlan) -> torch.Tensor:
    """One forward launch of ``csrc/dwconv.cu`` under ``plan``."""
    _cuda.require_cuda("dwconv", x, taps)
    _check_plan("dwconv", plan, x, taps, backward=False)
    out = torch.empty_like(x)
    with _cuda.on_device(x.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_dwconv(
            x.data_ptr(), taps.data_ptr(), out.data_ptr(), plan.c_plan[1], stream), "dwconv")
    _cuda.LAUNCHES["dwconv"] += 1
    return out


@counted("dwconv", lambda x, taps: (*x.shape, taps.shape[0]))
def dwconv_fwd(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The K5 forward for CUDA tensors, :func:`dwconv_plain` for CPU tensors."""
    kh, _, c = taps.shape
    _check("dwconv", x, kh, c)
    if x.device.type == "cpu":
        return dwconv_plain(x, taps)
    b, h, w, _ = x.shape
    return launch_fwd(x, taps, _cached_plan(b, h, w, c, kh, x.get_device(), False))


def launch_bwd(x: torch.Tensor, g: torch.Tensor, taps: torch.Tensor, plan: DwPlan,
               need_dx: bool = True, need_dtaps: bool = True):
    """One backward call of ``csrc/dwconv.cu`` under ``plan`` (the pass over
    ``g``, then the sum of the partials if ``need_dtaps``)."""
    _cuda.require_cuda("dwconv_bwd", x, g, taps)
    _check_plan("dwconv_bwd", plan, x, taps, backward=True)
    if g.shape != x.shape:
        raise ValueError(f"dwconv_bwd: shapes {tuple(x.shape)}, {tuple(g.shape)}")
    # dx, dtaps and the scratch in one allocation, the outputs as strided
    # views of it (dx first: its vector stores need the allocation's alignment)
    n_dx = x.numel() if need_dx else 0
    n_taps = taps.numel() if need_dtaps else 0
    n_scratch = plan.scratch_floats if need_dtaps else 0
    buf = torch.empty(n_dx + n_taps + n_scratch, dtype=torch.float32, device=x.device)
    dx = buf.as_strided(x.shape, x.stride(), 0) if need_dx else None
    dtaps = buf.as_strided(taps.shape, (3 * plan.c, plan.c, 1), n_dx) if need_dtaps else None
    base = buf.data_ptr()
    with _cuda.on_device(x.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_dwconv_bwd(
            x.data_ptr(), g.data_ptr(), taps.data_ptr(), base, base + 4 * n_dx,
            base + 4 * (n_dx + n_taps), plan.c_plan[1], int(need_dx), int(need_dtaps),
            stream), "dwconv_bwd")
    _cuda.LAUNCHES["dwconv"] += 1
    return dx, dtaps


@counted("dwconv_bwd", lambda x, g, taps, need_dx=True, need_dtaps=True:
         (*x.shape, taps.shape[0], int(need_dx) + int(need_dtaps)))
def dwconv_bwd(x: torch.Tensor, g: torch.Tensor, taps: torch.Tensor,
               need_dx: bool = True, need_dtaps: bool = True):
    """``(dx, dtaps)`` for the output gradient ``g`` (None where not
    needed): one K5 backward call for CUDA tensors, :func:`dwconv_bwd_plain`
    for CPU tensors."""
    kh, _, c = taps.shape
    _check("dwconv_bwd", x, kh, c)
    if g.shape != x.shape:
        raise ValueError(f"dwconv_bwd: shapes {tuple(x.shape)}, {tuple(g.shape)}")
    if x.device.type == "cpu":
        return dwconv_bwd_plain(x, g, taps, need_dx, need_dtaps)
    if not (need_dx or need_dtaps):
        return None, None
    b, h, w, _ = x.shape
    return launch_bwd(x, g, taps, _cached_plan(b, h, w, c, kh, x.get_device(), True),
                      need_dx, need_dtaps)


class _DWConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, taps):
        x, taps = x.contiguous(), taps.contiguous()
        ctx.save_for_backward(x, taps)
        return dwconv_fwd(x, taps)

    @staticmethod
    def backward(ctx, g):
        x, taps = ctx.saved_tensors
        return dwconv_bwd(x, g.contiguous(), taps, *ctx.needs_input_grad)


def dwconv(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Differentiable depthwise ``kh x 3`` conv (K5 forward and backward)."""
    return _DWConv.apply(x, taps)
