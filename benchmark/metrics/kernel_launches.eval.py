"""Device kernels launched in one eval forward and its metric sums: every kernel the traced
iterations ran, hand-written and library alike, over the iterations. The
host launches each one, so the count is the host's dispatch work."""

UNIT = "launches"
LAYER = "host dispatch"
MOVES = "eval_pairs_per_s"


def read(t):
    n = sum(1 for it in t.items if it.kind == "kernel")
    return n / t.iterations if n and t.iterations else None
