"""The port's supervised losses against the JAX package's, values and
gradients, for both orders, with and without validity masks. Predictions
come at several pyramid resolutions (2-D: resized to the target inside the
loss; 3-D: subset through pyramid sample indices). Float32, rtol 1e-5 for
values and 1e-4 (atol 1e-6 x the largest entry) for gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpeflow_tpu.nn.losses import supervised_loss_2d as jax_loss_2d
from rpeflow_tpu.nn.losses import supervised_loss_3d as jax_loss_3d
from rpeflow_tpu.train.config import ConfigNode
from rpeflow_tpu_torch.nn.losses import supervised_loss_2d, supervised_loss_3d

CFGS = [{"level_weights": [8, 4, 2, 1, 0.5]}, {"level_weights": None, "iters_weight_decay": 0.8}]


def _grads_close(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("order", ["l1", "l2"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cfg", CFGS)
def test_loss_2d_matches_jax(rng, order, masked, cfg):
    cfg = ConfigNode(dict(cfg, order=order))
    flows = [rng.randn(2, 16 >> i, 24 >> i, 2).astype(np.float32) for i in range(3)]
    flows[0][0, :2, :2] = 0.0  # exact zeros: the safe norm's gradient
    target = rng.randn(2, 30, 45, 2).astype(np.float32)
    if masked:
        target = np.concatenate([target, (rng.rand(2, 30, 45, 1) > 0.3)], -1).astype(np.float32)
    loss, vjp = jax.vjp(lambda *f: jax_loss_2d(list(f), jnp.asarray(target), cfg),
                        *map(jnp.asarray, flows))
    ref_grads = vjp(jnp.ones_like(loss))
    leaves = [torch.from_numpy(f).requires_grad_() for f in flows]
    out = supervised_loss_2d(leaves, torch.from_numpy(target), cfg)
    out.backward()
    np.testing.assert_allclose(out.item(), float(loss), rtol=1e-5)
    _grads_close([t.grad for t in leaves], ref_grads)


@pytest.mark.parametrize("order", ["l1", "l2"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cfg", CFGS)
def test_loss_3d_matches_jax(rng, order, masked, cfg):
    cfg = ConfigNode(dict(cfg, order=order))
    n = 64
    sizes = [n, 32, 16]
    indices = [np.tile(np.arange(n), (2, 1))] + [
        np.stack([rng.permutation(n)[:s] for _ in range(2)]) for s in sizes[1:]]
    flows = [rng.randn(2, s, 3).astype(np.float32) for s in sizes]
    target = rng.randn(2, n, 3).astype(np.float32)
    flows[1][0, 0] = target[0, indices[1][0, 0]]  # an exact zero difference
    if masked:
        target = np.concatenate([target, (rng.rand(2, n, 1) > 0.3)], -1).astype(np.float32)
    loss, vjp = jax.vjp(lambda *f: jax_loss_3d(list(f), jnp.asarray(target), cfg,
                                               [jnp.asarray(i) for i in indices]),
                        *map(jnp.asarray, flows))
    ref_grads = vjp(jnp.ones_like(loss))
    leaves = [torch.from_numpy(f).requires_grad_() for f in flows]
    out = supervised_loss_3d(leaves, torch.from_numpy(target), cfg,
                             [torch.from_numpy(i) for i in indices])
    out.backward()
    np.testing.assert_allclose(out.item(), float(loss), rtol=1e-5)
    _grads_close([t.grad for t in leaves], ref_grads)
