"""The hand-written kernels' share of their roofline in the traced
iterations: the least time of every call of each kernel's function at its
shape (``benchmark/lib/work.py : call_bound``, the calls as the frozen
reference makes them at the cell's shapes; the kernel names are
``benchmark/lib/work.py : HAND_KERNELS``), over those kernels' device
time. A function whose kernels did not run is left out of both sums."""

import collections

from benchmark.lib.work import call_bound

UNIT = "%"
LAYER = "kernels"
MOVES = "eval_pairs_per_s"


def read(t):
    device = collections.Counter()
    for it in t.items:
        if it.hand:
            device[it.hand] += it.dur_us / 1e6
    least = sum(call_bound(name, shape) / 1e3 for name, shape in t.calls if device[name] > 0)
    total = sum(device.values())
    return 100.0 * least * t.iterations / total if total and least else None
