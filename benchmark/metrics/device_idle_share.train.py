"""Share of the traced window in which the card ran nothing: one less the
union of the kernel, memcpy and memset intervals over the window. The
profiler lengthens the device work, so this is a lower bound on the idle
share of an untraced run."""

UNIT = "%"
LAYER = "device"
MOVES = "train_samples_per_s"


def read(t):
    if not t.items or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
