"""2-D cost volume: the port's plain version against the JAX
``correlation2d_ref`` and the Pallas kernel (interpret mode), including
unaligned maps, atol 1e-5. The CUDA kernel is held to the plain version in
tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from rpeflow_tpu.ops.correlation import correlation2d_ref
from rpeflow_tpu_torch.ops import correlation

SHAPES = [(2, 16, 16, 16), (2, 9, 15, 32), (1, 36, 60, 8), (1, 18, 30, 64)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_ref(rng, shape):
    f1, f2 = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    out = correlation.correlation2d(torch.from_numpy(f1), torch.from_numpy(f2), 4).numpy()
    assert out.shape == shape[:3] + (81,)
    np.testing.assert_allclose(out, np.asarray(correlation2d_ref(f1, f2, 4)), atol=1e-5)


def test_plain_other_displacement(rng):
    f1, f2 = rng.randn(1, 10, 12, 8).astype(np.float32), rng.randn(1, 10, 12, 8).astype(np.float32)
    out = correlation.correlation2d(torch.from_numpy(f1), torch.from_numpy(f2), 2).numpy()
    np.testing.assert_allclose(out, np.asarray(correlation2d_ref(f1, f2, 2)), atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 36, 60, 32), (1, 9, 15, 16)])
def test_plain_matches_pallas_interpret(rng, shape):
    from jax.experimental.pallas import tpu as pltpu

    from rpeflow_tpu.ops.pallas.correlation import correlation2d_pallas

    f1, f2 = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(correlation2d_pallas(f1, f2, 4))
    except Exception as e:  # interpreter support varies by backend
        pytest.skip(f"pallas interpret unavailable: {e}")
    out = correlation.correlation2d(torch.from_numpy(f1), torch.from_numpy(f2), 4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
