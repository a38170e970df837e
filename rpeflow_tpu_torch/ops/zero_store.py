"""Zero store (counterpart of the Pallas kernel
``triage/repro_xla_custom_call.py : pallas_zero``).

:func:`zero_store` ``(x [B, H, W, C], tile_h) -> float32 zeros of x's
shape``, written by ``csrc/zero_store.cu``. The Pallas kernel stores one
``(1, tile_h, W, C)`` tile per step of the grid ``(B, H // tile_h)``, 36
blocks at the repro's [2, 144, 240, 256], tile 8, on the H100's 132 SMs.
The zeros do not depend on that tiling, so the kernel's grid covers the
whole ``B * H * W * C`` span in 16 KB pieces, one a block (4,320 blocks
there), as 16-byte stores where the output's base allows, the last
``n % 4`` floats as 4-byte stores.

What bounds it on the H100: bytes, the output written once (the zeros read
no byte of ``x``): 70.8 MB, 21.1 us at 3.35 TB/s at the repro's shape.

The Pallas grid never writes the rows past ``(H // tile_h) * tile_h``, so
its output there is undefined; the port raises when ``H % tile_h != 0``
instead of pretending to match it. A CPU tensor takes
:func:`zero_store_plain`.
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
    dev = x.device
    if dev.type == "cpu":
        return zero_store_plain(x, tile_h)
    _check(x, tile_h)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    with _cuda.on_device(dev) as stream:
        _cuda.check(_cuda.lib().rpeflow_zero_store(out.data_ptr(), out.numel(), stream),
                    "zero_store")
    _cuda.LAUNCHES["zero_store"] += 1
    return out
