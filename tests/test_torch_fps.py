"""Furthest point sampling: the port's plain version against the JAX scan
and the Pallas kernel (interpret mode), index for index. The CUDA kernel is
held to the plain version in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from rpeflow_tpu.ops.fps import furthest_point_sampling_scan
from rpeflow_tpu_torch.ops import fps


@pytest.mark.parametrize("b,n,s", [(2, 100, 30), (3, 257, 128), (1, 64, 64)])
def test_plain_fps_equals_scan(rng, b, n, s):
    xyz = (rng.randn(b, n, 3) * [3.0, 2.0, 10.0]).astype(np.float32)
    out = fps.furthest_point_sampling(torch.from_numpy(xyz), s)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(furthest_point_sampling_scan(xyz, s)))


def test_plain_fps_ties_take_first_index():
    xyz = np.zeros((1, 10, 3), np.float32)
    xyz[0, 5:] = 1.0  # two clusters of identical points
    out = fps.furthest_point_sampling(torch.from_numpy(xyz), 4).numpy()
    np.testing.assert_array_equal(out, np.asarray(furthest_point_sampling_scan(xyz, 4)))
    np.testing.assert_array_equal(out, [[0, 5, 0, 0]])


def test_plain_fps_equals_pallas_interpret(rng):
    from jax.experimental.pallas import tpu as pltpu

    from rpeflow_tpu.ops.pallas.fps import furthest_point_sampling_pallas

    xyz = rng.randn(2, 128, 3).astype(np.float32)
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(furthest_point_sampling_pallas(xyz, 48))
    except Exception as e:  # interpreter support varies by backend
        pytest.skip(f"pallas interpret unavailable: {e}")
    out = fps.furthest_point_sampling(torch.from_numpy(xyz), 48).numpy()
    np.testing.assert_array_equal(out, ref)
