"""Peak of the allocated device memory over the traced train steps
(``torch.cuda.max_memory_allocated`` after a reset at their start): the
model, Adam's state, the activations a step keeps and the batches."""

UNIT = "GiB"
LAYER = "device"
MOVES = "train_samples_per_s"


def read(t):
    return t.peak_bytes / 2**30 if t.peak_bytes else None
