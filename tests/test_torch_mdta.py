"""MDTA front half, GDFN and the cross-attention block: the port against the
JAX package on the same numpy inputs. The CUDA kernels are held to their
plain versions in tests/test_torch_kernels_cuda.py.

Tolerances: v atol 1e-5; qk and sq (token sums in another order) within
1e-4 of their largest entry; GDFN and the block rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax

from rpeflow_tpu.nn.mdta import CrossTransformerBlock as JaxBlock
from rpeflow_tpu.nn.mdta import _gdfn_ref
from rpeflow_tpu_torch.compat import load_jax_variables
from rpeflow_tpu_torch.nn.mdta import CrossTransformerBlock
from rpeflow_tpu_torch.ops import gdfn, mdta
from torch_port_utils import fill_variables


def _mdta_inputs(rng, b, h, w, c, kh):
    x = rng.randn(b, h, w, c).astype(np.float32)
    y = rng.randn(b, h, w, c).astype(np.float32)
    ln = np.stack([rng.rand(c) + 0.5, rng.randn(c) * 0.1,
                   rng.rand(c) + 0.5, rng.randn(c) * 0.1]).astype(np.float32)
    dw = (rng.randn(kh, 3, 3 * c) * 0.2).astype(np.float32)
    return x, y, ln, dw


def _assert_sums_close(out, ref, name):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    assert rel <= 1e-4, f"{name}: error {rel:.2e} of the largest entry"


@pytest.mark.parametrize("shape,kh", [
    ((2, 16, 24, 12), 3),   # aligned 2-D map
    ((1, 9, 15, 8), 3),     # unaligned, odd rows
    ((2, 1, 64, 12), 1),    # point map: 1-D k=3 conv along N
])
def test_plain_mdta_qkv_matches_pallas_interpret(rng, shape, kh):
    from jax.experimental.pallas import tpu as pltpu

    from rpeflow_tpu.ops.pallas.mdta import mdta_qkv_pallas

    x, y, ln, dw = _mdta_inputs(rng, *shape, kh)
    try:
        with pltpu.force_tpu_interpret_mode():
            rv, rqk, rsq = map(np.asarray, mdta_qkv_pallas(x, y, ln, dw, kh=kh))
    except Exception as e:  # interpreter support varies by backend
        pytest.skip(f"pallas interpret unavailable: {e}")
    v, qk, sq = mdta.mdta_qkv(*map(torch.from_numpy, (x, y, ln, dw)), kh)
    np.testing.assert_allclose(v.numpy(), rv, atol=1e-5)
    _assert_sums_close(qk.numpy(), rqk, "qk")
    _assert_sums_close(sq.numpy(), rsq, "sq")


@pytest.mark.parametrize("b,h,w,c,hidden", [(2, 8, 12, 16, 42), (1, 9, 15, 20, 53)])
def test_plain_gdfn_matches_jax_ref(rng, b, h, w, c, hidden):
    x = rng.randn(b, h, w, c).astype(np.float32)
    w_in = (rng.randn(c, 2 * hidden) / np.sqrt(c)).astype(np.float32)
    w_dw = (rng.randn(3, 3, 2 * hidden) / 3).astype(np.float32)
    w_out = (rng.randn(hidden, c) / np.sqrt(hidden)).astype(np.float32)
    out = gdfn.gdfn(*map(torch.from_numpy, (x, w_in, w_dw, w_out))).numpy()
    ref = np.asarray(jax.jit(_gdfn_ref)(x, w_in, w_dw, w_out))
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,heads", [((2, 8, 12, 16), 2), ((1, 9, 15, 12), 3),
                                         ((2, 40, 16), 2), ((1, 33, 12), 1)])
def test_cross_transformer_block_matches_jax(rng, shape, heads):
    """The port's fused block vs the JAX module (unfused on the CPU), weights
    carried by load_jax_variables."""
    dim = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randn(*shape).astype(np.float32)
    jblock = JaxBlock(dim, heads)
    variables = fill_variables(jax.eval_shape(jblock.init, jax.random.PRNGKey(0), x, y), seed=3)
    ref = np.asarray(jax.jit(jblock.apply)(variables, x, y))

    block = CrossTransformerBlock(dim, heads, n_spatial=len(shape) - 2)
    load_jax_variables(block, variables, strict=True)
    with torch.inference_mode():
        out = block(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
