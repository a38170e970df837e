"""Fused MDTA attention (counterpart of the Pallas kernel
rpeflow_tpu/ops/pallas/mdta.py and of ``rpeflow_tpu/nn/mdta.py :
_mdta_attn_fused``), with autograd.

:func:`mdta_qkv` computes, for ``x, y [B, H, W, C]`` (point maps as
``[B, 1, N, C]``), the channel LayerNorm of x and y, the depthwise ``kh x 3``
conv giving q from x and k, v from y (zero padding applied to the LayerNorm
output), and returns ``v``, ``qk = sum_t q_t^T k_t [B, C, C]`` and
``sq = (sum_t q^2, sum_t k^2) [B, 2, C]``. It launches ``csrc/mdta.cu`` for
CUDA tensors, cut as :func:`mdta_plan` says (tile per width class, blocks
per batch element, scratch for the per-block partials), and runs
:func:`mdta_qkv_plain` for CPU tensors.

:func:`mdta_attention` is the whole attention before the residual, one
autograd function over ``(x, y, ln, dw, temperature, w_out)``:

* forward (:func:`mdta_attention_fused`): the kernel, then the glue of the
  JAX ``_mdta_attn_fused``: the token-axis l2 norms fold into the Gram
  matrix, the per-head softmax runs on its diagonal blocks, and
  ``(attn @ v) @ w_out`` becomes ``v @ M`` with
  ``M = blockdiag_h(attn_h^T) @ w_out``;
* backward: recompute :func:`mdta_attention_plain` (``_attn_ref_flat``)
  with the differentiable K5 depthwise conv for every ``kh`` (3 on maps,
  1 on points) and differentiate it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, replace

import torch

from . import _cuda
from ..utils.flops import counted
from ._autograd import vjp_by_recompute
from .dwconv import dwconv, dwconv_plain


def channel_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis: biased variance, eps inside the sqrt."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * weight + bias


def mdta_qkv_plain(x, y, ln, dw, kh):
    c = x.shape[-1]
    xn = channel_layer_norm(x, ln[0], ln[1])
    yn = channel_layer_norm(y, ln[2], ln[3])
    q = dwconv_plain(xn, dw[..., :c])
    k = dwconv_plain(yn, dw[..., c:2 * c])
    v = dwconv_plain(yn, dw[..., 2 * c:])
    b = x.shape[0]
    qf, kf = q.reshape(b, -1, c), k.reshape(b, -1, c)
    qk = torch.matmul(qf.transpose(1, 2), kf)
    sq = torch.stack([(qf * qf).sum(1), (kf * kf).sum(1)], dim=1)
    return v.contiguous(), qk, sq


#: the kernel's width classes: C padded to CP, NS Gram columns per slice
#: (above CP = 128 each slice of NS columns is its own block)
WIDTHS = ((32, 32), (64, 64), (96, 96), (128, 128), (192, 96), (256, 64))
#: tile (rows, columns, row segment) per (kh, CP): 8-row tiles on 2-D maps,
#: runs along N on point maps. The x and y halos and the q and k tiles fit
#: two 256-thread blocks per SM up to CP = 64 and one 512-thread block at
#: CP = 96; a row segment of 32 channels is one warp's unit of the taps.
#: ``scripts/torch_mdta_probe.py`` times other tiles.
TILES = {
    (3, 32): (8, 12, 6), (3, 64): (8, 8, 8), (3, 96): (8, 12, 12), (3, 128): (8, 4, 4),
    (3, 192): (8, 4, 4), (3, 256): (8, 4, 4),
    (1, 32): (1, 128, 16), (1, 64): (1, 64, 8), (1, 96): (1, 64, 4), (1, 128): (1, 64, 8),
    (1, 192): (1, 32, 4), (1, 256): (1, 32, 4),
}
SMEM_PER_BLOCK = 232448  # bytes a block may use on an H100
SMEM_PER_SM = 233472     # bytes an SM shares among its blocks, 1 KB reserved per block
#: blocks per SM that the kernel's launch bounds allow, by CP: two of 256
#: threads up to CP = 64, one of 512 threads at CP = 96, one of 256 above
#: (at most 128 registers a thread in the first two cases)
BLOCKS_PER_SM = {32: 2, 64: 2, 96: 1, 128: 1, 192: 1, 256: 1}


@dataclass(frozen=True)
class MdtaPlan:
    """How ``csrc/mdta.cu`` cuts one call: tiles of ``th x tw`` tokens (row
    segments of ``seg`` tokens), walked by ``nblk`` blocks per batch element
    and Gram slice (block ``blk`` takes tiles ``blk, blk + nblk, ...``)."""
    b: int
    h: int
    w: int
    c: int
    kh: int
    cp: int
    ns: int
    th: int
    tw: int
    seg: int
    nblk: int

    @property
    def slices(self) -> int:
        return self.cp // self.ns

    @property
    def tiles_w(self) -> int:
        return -(-self.w // self.tw)

    @property
    def tiles(self) -> int:
        """Tiles per batch element."""
        return -(-self.h // self.th) * self.tiles_w

    def tile_origin(self, t: int) -> tuple[int, int]:
        return (t // self.tiles_w) * self.th, (t % self.tiles_w) * self.tw

    def block_tiles(self, blk: int) -> range:
        return range(blk, self.tiles, self.nblk)

    @property
    def partial_floats(self) -> int:
        """One block's partial: qk ``[CP][NS]`` and sq ``[2][NS]``."""
        return self.cp * self.ns + 2 * self.ns

    @property
    def scratch_floats(self) -> int:
        return self.b * self.slices * self.nblk * self.partial_floats

    @functools.cached_property
    def c_plan(self) -> tuple[ctypes.Array, int]:
        """The plan as ``rpeflow_mdta_qkv`` reads it, an int64 array
        (scratch floats, B, H, W, C, kh, th, tw, seg, nblk), and its address;
        built once per plan (one pointer for ctypes to convert, not ten ints:
        the wrapper's host time sets the time of the small shapes)."""
        arr = (ctypes.c_longlong * 10)(self.scratch_floats, self.b, self.h, self.w, self.c,
                                       self.kh, self.th, self.tw, self.seg, self.nblk)
        return arr, ctypes.addressof(arr)

    @functools.cached_property
    def out_offsets(self) -> tuple[int, int, int]:
        """Ends of v, qk and sq in the call's one allocation, in floats (the
        scratch follows)."""
        n_v = self.b * self.h * self.w * self.c
        n_qk = n_v + self.b * self.c * self.c
        return n_v, n_qk, n_qk + 2 * self.b * self.c

    @property
    def halo_tokens(self) -> int:
        return (self.th + self.kh - 1) * (self.tw + 2)

    @property
    def smem_bytes(self) -> int:
        """x and y halos ``[halo tokens][CP]``, q ``[T][CP + 8]``, k
        ``[T][NS + 8]`` and the LayerNorm rows ``[4][CP]``, f32."""
        t = self.th * self.tw
        return 4 * (2 * self.halo_tokens * self.cp + t * (self.cp + 8) + t * (self.ns + 8)
                    + 4 * self.cp)


def mdta_plan(b: int, h: int, w: int, c: int, kh: int, num_sms: int = 132,
              tile: tuple[int, int, int] | None = None) -> MdtaPlan:
    """The kernel's plan for ``x [b, h, w, c]``: the width class of C, the
    tile of ``TILES`` (or ``tile``), and as many blocks as the card holds at
    once (at least one per batch element and slice), spread over the batch
    elements and slices."""
    if kh not in (1, 3) or not 1 <= c <= WIDTHS[-1][0]:
        raise ValueError(f"mdta_qkv: the kernel takes kh in (1, 3) and C <= 256, got {kh}, {c}")
    cp, ns = next((cp, ns) for cp, ns in WIDTHS if c <= cp)
    th, tw, seg = tile or TILES[kh, cp]
    plan = MdtaPlan(b, h, w, c, kh, cp, ns, th, tw, seg, 1)
    resident = max(1, min(BLOCKS_PER_SM[cp], SMEM_PER_SM // (plan.smem_bytes + 1024))) * num_sms
    return replace(plan, nblk=min(plan.tiles, max(1, resident // (b * plan.slices))))


@functools.lru_cache(maxsize=256)
def _cached_plan(b: int, h: int, w: int, c: int, kh: int, device_index: int) -> MdtaPlan:
    return mdta_plan(b, h, w, c, kh, _cuda.sm_count(device_index))


def launch_qkv(x, y, ln, dw, plan: MdtaPlan):
    """One call of ``csrc/mdta.cu`` under ``plan`` (two launches: the pass
    over the map, then the sum of the per-block partials)."""
    _cuda.require_cuda("mdta_qkv", x, y, ln, dw)
    b, c = plan.b, plan.c
    if x.shape != (b, plan.h, plan.w, c) or dw.shape[0] != plan.kh:
        raise ValueError(f"mdta_qkv: plan for {(b, plan.h, plan.w, c)}, kh={plan.kh}; got "
                         f"{tuple(x.shape)}, kh={dw.shape[0]}")
    # v, qk, sq and the scratch in one allocation, the outputs as strided
    # views of it: the allocator is the largest part of the wrapper's host
    # time, which sets the time of the small shapes
    n_v, n_qk, n_out = plan.out_offsets
    out = torch.empty(n_out + plan.scratch_floats, dtype=torch.float32, device=x.device)
    v = out.as_strided(x.shape, x.stride(), 0)
    qk = out.as_strided((b, c, c), (c * c, c, 1), n_v)
    sq = out.as_strided((b, 2, c), (2 * c, c, 1), n_qk)
    base = out.data_ptr()
    with _cuda.on_device(x.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_mdta_qkv(
            x.data_ptr(), y.data_ptr(), ln.data_ptr(), dw.data_ptr(), base, base + 4 * n_v,
            base + 4 * n_qk, base + 4 * n_out, plan.c_plan[1], stream), "mdta_qkv")
    _cuda.LAUNCHES["mdta_qkv"] += 1
    return v, qk, sq


@counted("mdta_qkv", lambda x, y, ln, dw, kh: (*x.shape, kh))
def mdta_qkv(x: torch.Tensor, y: torch.Tensor, ln: torch.Tensor, dw: torch.Tensor,
             kh: int):
    """``x, y [B, H, W, C]``, ``ln [4, C]`` rows (lnx_w, lnx_b, lny_w, lny_b),
    ``dw [kh, 3, 3C]`` taps in (q | k | v) order; kh is 3 for 2-D maps and 1
    for point maps. Returns ``(v, qk, sq)``, float32 (the K3 kernel for CUDA
    tensors, records no gradient)."""
    b, h, w, c = x.shape
    if y.shape != x.shape or ln.shape != (4, c) or dw.shape != (kh, 3, 3 * c):
        raise ValueError(f"mdta_qkv: shapes {tuple(x.shape)}, {tuple(ln.shape)}, "
                         f"{tuple(dw.shape)}, kh={kh}")
    if x.is_cpu:
        return mdta_qkv_plain(x, y, ln, dw, kh)
    return launch_qkv(x, y, ln, dw, _cached_plan(b, h, w, c, kh, x.get_device()))


def mdta_attention_fused(x, y, ln, dw, temperature, w_out, kh: int, heads: int):
    """The attention through :func:`mdta_qkv` and the glue above.
    ``temperature [heads, 1, 1]``, ``w_out [C, C]`` (``out = a @ w_out``)."""
    b, h, w, c = x.shape
    hc = c // heads
    v, qk, sq = mdta_qkv(x, y, ln, dw, kh)
    eps = 1e-12
    nq = torch.sqrt(torch.clamp(sq[:, 0], min=eps * eps))
    nk = torch.sqrt(torch.clamp(sq[:, 1], min=eps * eps))
    logits = qk / (nq[:, :, None] * nk[:, None, :])
    lr = logits.reshape(b, heads, hc, heads, hc)
    blocks = torch.stack([lr[:, i, :, i, :] for i in range(heads)], dim=1)
    attn = torch.softmax(blocks * temperature, dim=-1)  # [B, heads, hc, hc]
    eye = torch.eye(heads, dtype=attn.dtype, device=attn.device)
    bd = torch.einsum("bhcd,hg->bhdgc", attn, eye).reshape(b, c, c)
    m = torch.matmul(bd, w_out)
    return torch.matmul(v.reshape(b, h * w, c), m).reshape(b, h, w, c)


def mdta_attention_plain(x, y, ln, dw, temperature, w_out, kh: int, heads: int,
                         dw_fn=dwconv_plain):
    """``_attn_ref_flat``: LayerNorms, depthwise q/k/v through ``dw_fn``,
    l2-normalised transposed attention per head, projection."""
    b, h, w, c = x.shape
    xn = channel_layer_norm(x, ln[0], ln[1])
    yn = channel_layer_norm(y, ln[2], ln[3])
    q = dw_fn(xn, dw[..., :c])
    k = dw_fn(yn, dw[..., c:2 * c])
    v = dw_fn(yn, dw[..., 2 * c:])
    t, hc = h * w, c // heads
    q, k, v = (z.reshape(b, t, heads, hc) for z in (q, k, v))
    eps = 1e-12
    q = q / torch.sqrt(torch.clamp((q * q).sum(1, keepdim=True), min=eps * eps))
    k = k / torch.sqrt(torch.clamp((k * k).sum(1, keepdim=True), min=eps * eps))
    attn = torch.softmax(torch.einsum("bthc,bthd->bhcd", q, k) * temperature, dim=-1)
    out = torch.einsum("bhcd,bthd->bthc", attn, v)
    return torch.matmul(out.reshape(b, t, c), w_out).reshape(b, h, w, c)


class _MDTAAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, ln, dw, temperature, w_out, kh, heads):
        args = [t.contiguous() for t in (x, y, ln, dw, temperature, w_out)]
        ctx.save_for_backward(*args)
        ctx.kh, ctx.heads = kh, heads
        return mdta_attention_fused(*args, kh, heads)

    @staticmethod
    def backward(ctx, g):
        kh, heads = ctx.kh, ctx.heads
        grads = vjp_by_recompute(
            lambda *a: mdta_attention_plain(*a, kh, heads, dw_fn=dwconv),
            ctx.saved_tensors, ctx.needs_input_grad[:6], g)
        return (*grads, None, None)


def mdta_attention(x, y, ln, dw, temperature, w_out, kh: int, heads: int) -> torch.Tensor:
    """Differentiable MDTA attention before the residual (K3 forward, K5
    inside the recomputed backward). ``x, y [B, H, W, C]`` (points
    ``[B, 1, N, C]``), ``ln [4, C]``, ``dw [kh, 3, 3C]``,
    ``temperature [heads, 1, 1]``, ``w_out [C, C]``."""
    return _MDTAAttention.apply(x, y, ln, dw, temperature, w_out, kh, heads)
