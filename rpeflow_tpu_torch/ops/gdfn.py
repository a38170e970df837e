"""Gated depthwise-conv feed-forward (counterpart of the Pallas kernel
rpeflow_tpu/ops/pallas/gdfn.py), forward only.

``y = (gelu(h1) * h2) @ w_out`` with ``[h1 | h2] = dw3x3(x @ w_in)``, zero
padding, no biases, exact GELU (``rpeflow_tpu/nn/mdta.py : _gdfn_ref``).
:func:`gdfn` launches ``csrc/gdfn.cu`` for CUDA tensors and runs
:func:`gdfn_plain` for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .mdta import depthwise_conv


def gdfn_plain(x, w_in, w_dw, w_out):
    hidden = w_in.shape[1] // 2
    h = depthwise_conv(torch.matmul(x, w_in), w_dw)
    g = F.gelu(h[..., :hidden], approximate="none") * h[..., hidden:]
    return torch.matmul(g, w_out)


def gdfn(x: torch.Tensor, w_in: torch.Tensor, w_dw: torch.Tensor,
         w_out: torch.Tensor) -> torch.Tensor:
    """``x [B, H, W, C]``, ``w_in [C, 2h]``, ``w_dw [3, 3, 2h]``,
    ``w_out [h, C]`` -> ``[B, H, W, C]`` float32."""
    b, h, w, c = x.shape
    h2 = w_in.shape[1]
    hidden = h2 // 2
    if w_in.shape != (c, h2) or w_dw.shape != (3, 3, h2) or w_out.shape != (hidden, c):
        raise ValueError(f"gdfn: shapes {tuple(x.shape)}, {tuple(w_in.shape)}, "
                         f"{tuple(w_dw.shape)}, {tuple(w_out.shape)}")
    if x.device.type == "cpu":
        return gdfn_plain(x, w_in, w_dw, w_out)
    if -(-b * h * w // 64) > 65535:
        raise ValueError("gdfn: too many pixels for the kernel's grid")
    _cuda.require_cuda("gdfn", x, w_in, w_dw, w_out)
    pixels = b * h * w
    scratch = torch.empty(pixels * 3 * hidden, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    _cuda.check(_cuda.lib().rpeflow_gdfn(
        x.data_ptr(), w_in.data_ptr(), w_dw.data_ptr(), w_out.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, h, w, c, hidden, _cuda.stream()), "gdfn")
    _cuda.LAUNCHES["gdfn"] += 1
    return out
