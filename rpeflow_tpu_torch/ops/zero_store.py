"""Zero store (counterpart of the Pallas kernel
``triage/repro_xla_custom_call.py : pallas_zero``).

:func:`zero_store` ``(x [B, H, W, C], tile_h) -> float32 zeros of x's
shape``, written by ``csrc/zero_store.cu`` one block per ``(b, tile of
tile_h rows)``, the Pallas grid ``(B, H // tile_h)``. That grid never writes
the rows past ``(H // tile_h) * tile_h``, so the Pallas output there is
undefined; the port raises when ``H % tile_h != 0`` instead of pretending to
match it. A CPU tensor takes :func:`zero_store_plain`.
"""

from __future__ import annotations

import torch

from . import _cuda


def _check(x: torch.Tensor, tile_h: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"zero_store: expected [B, H, W, C], got {tuple(x.shape)}")
    if tile_h <= 0 or x.shape[1] % tile_h:
        raise ValueError(f"zero_store: H = {x.shape[1]} is not a multiple of tile_h = {tile_h}")


def zero_store_plain(x: torch.Tensor, tile_h: int) -> torch.Tensor:
    """Float32 zeros of ``x``'s shape."""
    _check(x, tile_h)
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device)


def zero_store(x: torch.Tensor, tile_h: int) -> torch.Tensor:
    """Float32 zeros of ``x``'s shape, stored by the kernel for a CUDA ``x``."""
    if x.device.type == "cpu":
        return zero_store_plain(x, tile_h)
    _check(x, tile_h)
    b, h, w, c = x.shape
    out = torch.empty(b, h, w, c, dtype=torch.float32, device=x.device)
    with _cuda.on_device(x.device) as stream:
        _cuda.check(_cuda.lib().rpeflow_zero_store(out.data_ptr(), b, h, w * c, tile_h, stream),
                    "zero_store")
    _cuda.LAUNCHES["zero_store"] += 1
    return out
