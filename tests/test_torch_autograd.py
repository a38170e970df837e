"""The port's autograd functions on the CPU against ``jax.vjp`` of the JAX
package's backward oracles: ``_dw_flat`` (depthwise conv),
``_correlation2d_bwd_ref`` (cost volume), ``_gdfn_ref`` (GDFN) and
``_attn_ref_flat`` (MDTA attention). On the CPU the functions run their
plain versions forward and backward (for the depthwise conv,
``dwconv_bwd_plain``: the rotated-taps input gradient and the taps-gradient
formula) and the same recomputed compositions as on the card. Same numpy
inputs on both sides; float32 sums in another order, so rtol 1e-4 with an
atol of 1e-5 times the largest reference entry.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpeflow_tpu.nn.mdta import _attn_ref_flat, _dw_flat, _gdfn_ref
from rpeflow_tpu.ops.correlation import _correlation2d_bwd_ref, correlation2d_ref
from rpeflow_tpu_torch.ops import correlation, dwconv, gdfn, mdta


def _close(out, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-5 * max(float(np.abs(ref).max()), 1.0), err_msg=name)


def _port_vjp(fn, inputs, g):
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*leaves)
    out.backward(torch.from_numpy(g))
    return out, [t.grad for t in leaves]


def _check(fn_port, fn_jax, inputs, rng, names):
    ref_out, vjp = jax.vjp(fn_jax, *map(jnp.asarray, inputs))
    g = rng.randn(*ref_out.shape).astype(np.float32)
    ref_grads = vjp(jnp.asarray(g))
    out, grads = _port_vjp(fn_port, inputs, g)
    _close(out, ref_out, "forward")
    for name, got, ref in zip(names, grads, ref_grads):
        _close(got, ref, name)


@pytest.mark.parametrize("shape,kh", [((2, 6, 7, 5), 3), ((2, 1, 9, 5), 1), ((1, 4, 33, 40), 3)])
def test_dwconv_gradients_match_dw_flat(rng, shape, kh):
    x = rng.randn(*shape).astype(np.float32)
    taps = rng.randn(kh, 3, shape[-1]).astype(np.float32)
    _check(dwconv.dwconv, functools.partial(_dw_flat, kh=kh), [x, taps], rng, ["x", "taps"])


@pytest.mark.parametrize("kh", [3, 1])
def test_dwconv_input_gradient_is_the_rotated_taps_conv(rng, kh):
    """The identity the kernel's backward rests on: the input gradient of a
    stride-1 zero-padded depthwise cross-correlation is the same conv of the
    output gradient with the taps rotated by 180 degrees."""
    x = rng.randn(2, 3 if kh == 3 else 1, 8, 4).astype(np.float32)
    taps = rng.randn(kh, 3, 4).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda z: _dw_flat(z, jnp.asarray(taps), kh), jnp.asarray(x))
    rotated = dwconv.dwconv_fwd(torch.from_numpy(g), torch.from_numpy(taps).flip(0, 1))
    _close(rotated, vjp(jnp.asarray(g))[0], "rotated-taps conv")


@pytest.mark.parametrize("shape,kh", [((2, 6, 7, 5), 3), ((1, 9, 11, 8), 3), ((2, 1, 13, 6), 1),
                                      ((3, 1, 7, 81), 1), ((2, 5, 1, 7), 3), ((2, 1, 9, 3), 3),
                                      ((1, 1, 1, 4), 3)])
def test_dwconv_bwd_plain_matches_dw_flat_vjp(rng, shape, kh):
    """The fused backward's plain version against ``jax.vjp`` of ``_dw_flat``
    on 2-D maps and point maps, C not a multiple of 4, W = 1 and H = 1: dx
    atol 1e-5, dtaps (a sum over every pixel) within 1e-4 of its largest
    entry; each gradient left out on request."""
    x = rng.randn(*shape).astype(np.float32)
    taps = rng.randn(kh, 3, shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(functools.partial(_dw_flat, kh=kh), jnp.asarray(x), jnp.asarray(taps))
    ref_dx, ref_dtaps = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    xt, gt, tt = (torch.from_numpy(a) for a in (x, g, taps))
    dx, dtaps = dwconv.dwconv_bwd_plain(xt, gt, tt)
    np.testing.assert_allclose(dx.numpy(), ref_dx, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dtaps.numpy(), ref_dtaps, rtol=0,
                               atol=1e-4 * float(np.abs(ref_dtaps).max()))
    only_dx, no_dtaps = dwconv.dwconv_bwd(xt, gt, tt, need_dtaps=False)
    no_dx, only_dtaps = dwconv.dwconv_bwd(xt, gt, tt, need_dx=False)
    assert no_dtaps is None and no_dx is None
    assert torch.equal(only_dx, dx) and torch.equal(only_dtaps, dtaps)


@pytest.mark.parametrize("shape,d", [((2, 7, 9, 6), 4), ((1, 5, 12, 3), 2)])
def test_correlation_gradients_match_bwd_ref(rng, shape, d):
    f1, f2 = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    side = 2 * d + 1
    g = rng.randn(*shape[:3], side * side).astype(np.float32)
    ref1, ref2 = _correlation2d_bwd_ref(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(g), d)
    out, (g1, g2) = _port_vjp(lambda a, b: correlation.correlation2d(a, b, d), [f1, f2], g)
    _close(out, correlation2d_ref(f1, f2, d), "forward")
    _close(g1, ref1, "f1")
    _close(g2, ref2, "f2")
    _, vjp = jax.vjp(lambda a, b: correlation2d_ref(a, b, d), jnp.asarray(f1), jnp.asarray(f2))
    auto1, auto2 = vjp(jnp.asarray(g))
    _close(g1, auto1, "f1 vs autodiff")
    _close(g2, auto2, "f2 vs autodiff")


@pytest.mark.parametrize("shape", [(2, 6, 7, 8), (1, 9, 5, 16)])
def test_gdfn_gradients_match_gdfn_ref(rng, shape):
    c = shape[-1]
    hidden = int(c * 2.66)
    inputs = [rng.randn(*shape).astype(np.float32),
              (rng.randn(c, 2 * hidden) / np.sqrt(c)).astype(np.float32),
              (rng.randn(3, 3, 2 * hidden) / 3).astype(np.float32),
              (rng.randn(hidden, c) / np.sqrt(hidden)).astype(np.float32)]
    _check(gdfn.gdfn, _gdfn_ref, inputs, rng, ["x", "w_in", "w_dw", "w_out"])


@pytest.mark.parametrize("shape,kh,heads", [((2, 6, 7, 8), 3, 2), ((2, 1, 11, 8), 1, 1),
                                            ((1, 5, 6, 12), 3, 3)])
def test_mdta_attention_gradients_match_attn_ref_flat(rng, shape, kh, heads):
    c = shape[-1]
    inputs = [rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32),
              np.stack([1 + 0.1 * rng.randn(c), 0.1 * rng.randn(c),
                        1 + 0.1 * rng.randn(c), 0.1 * rng.randn(c)]).astype(np.float32),
              (0.3 * rng.randn(kh, 3, 3 * c)).astype(np.float32),
              (1 + 0.1 * rng.randn(heads, 1, 1)).astype(np.float32),
              (rng.randn(c, c) / np.sqrt(c)).astype(np.float32)]
    _check(lambda *a: mdta.mdta_attention(*a, kh, heads),
           functools.partial(_attn_ref_flat, kh=kh, num_heads=heads), inputs, rng,
           ["x", "y", "ln", "dw", "temperature", "w_out"])
