"""Whole-iteration share of the card's float32 peak over the traced window:
the FLOPs of one train step (forward, losses, MI, backward, Adam), counted on the benchmark's frozen reference at the
cell's shapes (``benchmark/lib/flops.py``, each hand-written kernel's
function at its formula), times the traced iterations, over the traced
window, against 67 TFLOP/s. The traced window is lengthened by the
profiler, so this reads below the untraced share."""

from benchmark.lib.work import PEAK_F32

UNIT = "%"
LAYER = "step"
MOVES = "train_samples_per_s"


def read(t):
    if not t.items or not t.flops_per_iter or not t.window_s:
        return None
    return 100.0 * t.flops_per_iter * t.iterations / t.window_s / PEAK_F32
