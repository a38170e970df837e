"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both the
JAX package and the port, so the two see bit-identical data.
"""

import numpy as np
import pytest


@pytest.fixture
def cuda_device():
    """The first CUDA device, for the ``cuda``-marked kernel-vs-plain tests;
    they skip where there is no card (decided here, not at import)."""
    import torch

    from rpeflow_tpu_torch.train.precision import use_f32

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    use_f32()
    return torch.device("cuda:0")


def small_cfg_dict(k=8, event_bins=2):
    """Model block of conf/test/things.yaml, cut to a tiny KNN k."""
    return {
        "name": "RPEFlow",
        "ids": {"enabled": True, "sensor_size_divisor": 32},
        "pwc2d": {
            "event_bins": event_bins, "event_polarity": True,
            "norm": {"feature_pyramid": "batch_norm", "flow_estimator": None,
                     "context_network": None},
            "max_displacement": 4,
        },
        "pwc3d": {
            "norm": {"feature_pyramid": "batch_norm", "correlation": None,
                     "flow_estimator": None},
            "k": k,
        },
    }


def make_inputs(seed, b=2, h=64, w=64, n=64, event_ch=4, targets=False):
    """Channels-last numpy batch whose points project inside the image."""
    rng = np.random.RandomState(seed)
    f, cx, cy = 0.9 * w, (w - 1) / 2, (h - 1) / 2
    z = rng.uniform(3.0, 20.0, (b, n)).astype(np.float32)
    u = rng.uniform(0, w - 1, (b, n))
    v = rng.uniform(0, h - 1, (b, n))
    pc1 = np.stack([(u - cx) * z / f, (v - cy) * z / f, z], -1).astype(np.float32)
    flow3d = (rng.randn(b, n, 3) * 0.1).astype(np.float32)
    out = {
        "images": (rng.rand(b, h, w, 6) * 255).astype(np.uint8),
        "pcs": np.concatenate([pc1, pc1 + flow3d], -1).astype(np.float32),
        "event_voxel": rng.rand(b, h, w, event_ch).astype(np.float32),
        "intrinsics": np.tile(np.float32([f, cx, cy]), (b, 1)),
    }
    if targets:
        flow2d = rng.randn(b, h, w, 2).astype(np.float32) * 2
        mask = (rng.rand(b, h, w, 1) > 0.1).astype(np.float32)
        out["flow_2d"] = np.concatenate([flow2d, mask], -1)
        out["flow_3d"] = flow3d
        out["occ_mask_3d"] = (rng.rand(b, n) > 0.8).astype(np.float32)
    return out


def fill_variables(shape_tree, seed):
    """Numpy values for a JAX variable-shape tree (``jax.eval_shape`` of
    ``init``): fan-in-scaled kernels, small biases, BatchNorm var > 0."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            val = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "var":
            val = 0.5 + rng.rand(*shape)
        elif name in ("scale", "weight", "temperature"):
            val = 1.0 + 0.1 * rng.randn(*shape)
        else:  # bias, mean
            val = 0.1 * rng.randn(*shape)
        return val.astype(np.float32)

    def walk(node, path):
        if hasattr(node, "shape") and not isinstance(node, dict):
            return fill(path, node)
        return {k: walk(v, path + (k,)) for k, v in node.items()}

    return walk(shape_tree, ())


def assert_flow_close(actual, desired, msg, atol=2e-2):
    """Tolerance model of tests/test_wrapper_parity.py: sum-order noise
    accumulates over the decode and a few points flip KNN/FPS ties, so hold
    a quantile and the mean instead of every element."""
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, (actual.shape, desired.shape)
    d = np.abs(actual - desired)
    frac_ok = float((d <= atol + 1e-3 * np.abs(desired)).mean())
    assert frac_ok >= 0.995, (
        f"{msg}: only {frac_ok:.4%} of elements within tolerance (max |d| {d.max():.4f})")
    assert float(d.mean()) < atol, f"{msg}: mean |d| {d.mean():.5f}"


# (h, w, C, points) of the flagship eval forward's decode levels 1-5
# (576x960 -> 144x240 at level 1, 8192 points -> 4096 at level 1)
_LEVELS = [(144 >> i, 240 >> i, [32, 64, 96, 128, 192][i], 4096 >> i) for i in range(5)]
#: (B, H, W, C, kh) of the 30 MDTA kernel calls of one flagship eval forward:
#: per level the map's block at its own C, the two fusers at 81 and 96, and
#: the point maps (kh = 1)
MDTA_FLAGSHIP_SHAPES = [s for h, w, c, n in _LEVELS for s in (
    (8, h, w, c, 3), (4, h, w, 81, 3), (4, h, w, 96, 3),
    (8, 1, n, c, 1), (4, 1, n, c, 1), (4, 1, n, 64, 1))]
#: MDTA edge shapes at every width the model uses: maps whose H and W are
#: not multiples of the 8-row tiles or their 4/8/16 columns, one token, a
#: 120 x 160 map (a quarter of DSEC's frame), point runs of N not a multiple of the run;
#: then a map of many tiles per batch element, and a batch of more blocks
#: than the card holds at once
MDTA_EDGE_SHAPES = [(b, h, w, c, kh) for c in (32, 64, 81, 96, 128, 192)
                    for b, h, w, kh in ((1, 1, 1, 3), (1, 7, 15, 3), (2, 13, 30, 3),
                                        (4, 120, 160, 3), (2, 1, 777, 1), (1, 1, 1, 1))]
MDTA_EDGE_SHAPES += [(8, 144, 240, 32, 3), (300, 1, 16, 192, 1)]
