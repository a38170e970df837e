"""The conv blocks' share of their roofline in the traced eval forwards: the
least time of the convolutions the program's conv blocks (every
``ConvNormAct``) run, each at the larger of its FLOPs at 67 TFLOP/s and its
bytes (input, weight, output) at 3.35 TB/s, counted on the frozen
reference at the cell's shapes, over the device time of every kernel
launched inside those blocks' module scopes (the conv, whatever algorithm
runs it, and the norm and activation after it). Forward only: the
backward's kernels carry no module scope."""

UNIT = "%"
LAYER = "conv blocks"
MOVES = "eval_pairs_per_s"


def read(t):
    device = sum(it.dur_us for it in t.items if it.module in t.conv_modules) / 1e6
    if not device or not t.conv_least_s:
        return None
    return 100.0 * t.conv_least_s * t.iterations / device
