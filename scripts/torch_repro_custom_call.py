#!/usr/bin/env python3
"""The graph of triage/repro_xla_custom_call.py on the card (the port's
counterpart): a kernel that stores only zeros, put into a conv stack.

    python scripts/torch_repro_custom_call.py [--batch 2] [--hw 144 240] \\
        [--channels 256] [--tile-h 8] [--pressure-gb 0] [--no-discard] [--device cuda]

    x -> conv3x3 -> conv3x3 -> y ------------------+--> dilated conv stack -> out
                                \\-> zero_store -> (discarded, or added to y)

On the TPU the JAX script found that a Mosaic custom call whose output is
discarded poisoned the conv stack after it with NaNs. The same graph here
runs two 3x3 convs, ``ops.zero_store.zero_store`` (csrc/zero_store.cu, the
counterpart of ``pallas_zero``) on their output, then six dilated 3x3 convs
(d = 1, 2, 4, 8, 16, 1), each with a leaky ReLU (slope 0.01). The input and
the eight weight sets come from ``np.random.RandomState(0)`` exactly as in
the JAX script (weights HWIO, scaled 1.5 / sqrt(9 C)); ``--pressure-gb``
keeps that many GB of extra buffers live across the graph. PyTorch runs
eagerly, so the zero store runs whether its output is discarded or
(``--no-discard``) added to ``y``. Prints FINITE (exit 0) or NON-FINITE
(exit 1). Convolutions run in float32 with TF32 off.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from rpeflow_tpu_torch.ops.zero_store import zero_store  # noqa: E402
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402
from rpeflow_tpu_torch.utils.timing import card_line, resolve_device, sync  # noqa: E402

DILATIONS = (1, 2, 4, 8, 16, 1)


def conv(x, w, d=1):
    """SAME 3x3 conv (dilation ``d``) of NHWC ``x`` with HWIO ``w``, then a
    leaky ReLU; NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=d, dilation=d)
    return F.leaky_relu(y, 0.01).permute(0, 2, 3, 1)


def graph(x, ws, pressure, tile_h, discard):
    y = conv(conv(x, ws[0]), ws[1])
    k = zero_store(y, tile_h)
    if not discard:
        y = y + k
    for i, d in enumerate(DILATIONS):
        y = conv(y, ws[2 + i], d)
    p = sum(q.sum() * 1e-30 for q in pressure) if pressure else 0.0
    return y + p


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--hw", type=int, nargs=2, default=(144, 240))
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--tile-h", type=int, default=8)
    ap.add_argument("--pressure-gb", type=float, default=0.0,
                    help="extra live device memory across the graph")
    ap.add_argument("--no-discard", action="store_true",
                    help="add the kernel's output to y instead of discarding it")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    use_f32()

    b, (h, w), c = args.batch, args.hw, args.channels
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev)
    ws = [torch.from_numpy((rng.randn(3, 3, c, c) * (1.5 / np.sqrt(9 * c))).astype(np.float32))
          .to(dev) for _ in range(8)]
    n_pressure = int(args.pressure_gb * 2 ** 30 / 4 / (1 << 20))
    pressure = [torch.from_numpy(rng.randn(1 << 20).astype(np.float32)).to(dev)
                for _ in range(n_pressure)]

    with torch.no_grad():
        out = graph(x, ws, pressure, args.tile_h, not args.no_discard)
    sync(dev)
    finite = torch.isfinite(out)
    nonfinite = int(out.numel() - int(finite.sum()))
    print(f"batch={b} hw={h}x{w} c={c} pressure={args.pressure_gb}GB "
          f"discard={not args.no_discard} -> "
          f"{'FINITE' if nonfinite == 0 else f'NON-FINITE ({nonfinite} elems)'}", flush=True)
    return 0 if nonfinite == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
