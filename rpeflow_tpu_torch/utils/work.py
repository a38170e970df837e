"""The work of one call of each hand-written kernel's function, counted from
its shapes alone.

:func:`kernel_work` gives the bytes and operations that :func:`bound` turns
into the least time the card could take for a call (``chip_smoke.py``
phases 3 and 11). :func:`kernel_flops` is the useful floating-point work of
a call of a model kernel's function, products and convolutions only, which
:mod:`.flops` adds for each wrapper call to a workload's count: each
product once (GDFN's, not as the three TF32 passes the bound counts), no
elementwise epilogue (layer norms, the GELU gate, the squared sums, the
mean over the channels), and the correlation's backward only where a
backward runs.
"""

from __future__ import annotations

import numpy as np

from . import timing


def bound(nbytes, f32_ops, tf32_ops=0.0):
    """(ms, "bytes" | "operations") of the least time for the work."""
    t_bytes = nbytes / timing.PEAK_BYTES
    t_ops = max(f32_ops / timing.PEAK_F32, tf32_ops / timing.PEAK_TF32)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_work(name, shape):
    """(bytes, f32 operations, TF32 tensor-core operations) of one call of
    the function at ``shape``, counted from the shapes alone."""
    f = 4  # float32 / int32 bytes
    if name == "fps":  # xyz [B, N, 3] -> [B, S]; a step and point: 3 sub, 3 mul, 2 add,
        # min, compare
        b, n, s = shape
        return f * (b * n * 3 + b * s), 10.0 * b * s * n, 0.0
    if name == "correlation2d":  # f1, f2 [B, H, W, C] -> [B, H, W, 81]
        b, h, w, c = shape
        return f * (2 * b * h * w * c + 81 * b * h * w), 2.0 * 81 * c * b * h * w, 0.0
    if name == "correlation2d_bwd":  # f1, f2, g in; grad1, grad2 out; 81 C FMAs a
        # pixel for each gradient
        b, h, w, c = shape
        return f * b * h * w * (4 * c + 81), 4.0 * 81 * c * b * h * w, 0.0
    if name == "mdta_qkv":  # LN of x, y; kh x 3 taps on 3C; Gram C x C and sq over the pixels
        b, h, w, c, kh = shape
        p = b * h * w
        nbytes = f * (3 * p * c + 4 * c + kh * 9 * c + b * c * c + 2 * b * c)
        return nbytes, p * (2 * 8.0 * c + 3 * 2.0 * kh * 3 * c + 2.0 * c * c + 4.0 * c), 0.0
    if name == "gdfn":  # products x @ w_in, g @ w_out; 3x3 taps on 2h; gate (erf ~ 10 ops)
        b, h, w, c = shape
        p, hid = b * h * w, int(2.66 * c)
        nbytes = f * (2 * p * c + 3 * c * hid + 9 * 2 * hid)
        products = 2.0 * p * 3 * hid * c
        # 3xTF32: three tensor-core products for each f32 one
        return nbytes, p * (2.0 * 9 * 2 * hid + 12.0 * hid), 3 * products
    if name == "dwconv":  # forward, input and taps gradients: x, gout, taps in; out, dx,
        # dtaps out
        b, h, w, c, kh = shape
        p = b * h * w
        return f * (4 * p * c + 2 * kh * 3 * c), 3 * 2.0 * kh * 3 * p * c, 0.0
    if name in ("gather_rows", "gather_lanes"):  # (B, N, M, C, itemsize): table and int32
        # indices read once, one table row (column) per index written
        b, n, m, c, item = shape
        return item * (b * n * c + b * m * c) + 4 * b * m, 0.0, 0.0
    if name == "zero_store":  # [B, H, W, C] float32 zeros written; no byte of x is needed
        return f * int(np.prod(shape)), 0.0, 0.0
    if name == "conv3x3":  # x [B, H, W, Cin], w [Cout, Cin, 3, 3], bias in; [B, H, W, Cout]
        # out; 9 Cin Cout FMAs a pixel
        b, h, w, cin, cout = shape[:5]
        p = b * h * w
        return f * (p * (cin + cout) + 9 * cin * cout + cout), 2.0 * 9 * cin * cout * p, 0.0
    raise KeyError(name)


def kernel_flops(name, shape):
    """Useful floating-point operations of one call of a model kernel's
    function at ``shape`` (a multiply-add is 2):

    * ``fps`` (B, N, S): each step's distance from the newest sample to
      every point, 3 subtractions, 3 products and 2 sums (the min and the
      argmax are comparisons, not counted);
    * ``correlation2d`` (B, H, W, C, d): C products and sums for each of
      the (2d + 1)^2 shifts of each pixel;
    * ``correlation2d_bwd`` (B, H, W, C, d): the same for each of the two
      gradients;
    * ``mdta_qkv`` (B, H, W, C, kh): the kh x 3 depthwise taps of q, k and
      v, and the Gram q^T k over the pixels;
    * ``gdfn`` (B, H, W, C, hidden): the products x @ w_in ([C, 2 hidden])
      and g @ w_out ([hidden, C]), once each, and the 3 x 3 depthwise taps
      on the 2 hidden channels;
    * ``dwconv`` (B, H, W, C, kh): the kh x 3 depthwise taps;
    * ``dwconv_bwd`` (B, H, W, C, kh, n): as many again for each of the
      ``n`` gradients asked for (input, taps);
    * ``conv3x3`` (B, H, W, Cin, Cout, d): 9 Cin products and sums for
      each output channel of each pixel (the bias not counted), as a
      convolution counts.
    """
    if name == "fps":
        b, n, s = shape
        return 8.0 * b * n * s
    if name in ("correlation2d", "correlation2d_bwd"):
        b, h, w, c, d = shape
        per_gradient = 2.0 * (2 * d + 1) ** 2 * c * b * h * w
        return per_gradient * (2 if name == "correlation2d_bwd" else 1)
    if name == "mdta_qkv":
        b, h, w, c, kh = shape
        p = b * h * w
        return p * (2.0 * kh * 3 * 3 * c + 2.0 * c * c)
    if name == "gdfn":
        b, h, w, c, hidden = shape
        p = b * h * w
        return p * (2.0 * 3 * hidden * c + 2.0 * 9 * 2 * hidden)
    if name == "dwconv":
        b, h, w, c, kh = shape
        return 2.0 * kh * 3 * b * h * w * c
    if name == "dwconv_bwd":
        b, h, w, c, kh, n = shape
        return n * 2.0 * kh * 3 * b * h * w * c
    if name == "conv3x3":
        b, h, w, cin, cout, _ = shape
        return 2.0 * 9 * cin * cout * b * h * w
    raise KeyError(name)
