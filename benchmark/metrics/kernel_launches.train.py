"""Device kernels launched in one train step (forward, losses, MI, backward, Adam): every kernel the traced
iterations ran, hand-written and library alike, over the iterations. The
host launches each one, so the count is the host's dispatch work."""

UNIT = "launches"
LAYER = "host dispatch"
MOVES = "train_samples_per_s"


def read(t):
    n = sum(1 for it in t.items if it.kind == "kernel")
    return n / t.iterations if n and t.iterations else None
