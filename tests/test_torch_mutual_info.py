"""The port's mutual-information regulariser against the JAX package's, with
the same reparametrisation noise: numpy draws replayed in call order through
``jax.random.normal`` on the JAX side and ``draw_noise`` on the port's.
2-D maps and point sets, 2 and 3 modalities; the loss and its gradients for
the head weights and the input features, rtol 1e-4 (atol 1e-6 x the largest
entry)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpeflow_tpu.compat.torch_loader import to_torch_state_dict
from rpeflow_tpu.nn.mutual_info import MutualInfoReg as JaxMI
import rpeflow_tpu_torch.nn.mutual_info as port_mi
from torch_port_utils import fill_variables

C, HIDDEN = 8, 4


def _close(got, ref, name):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * max(np.abs(ref).max(), 1.0),
                               err_msg=name)


@pytest.mark.parametrize("n_modalities", [2, 3])
@pytest.mark.parametrize("shape", [(2, 5, 6), (2, 40)])
def test_mi_matches_jax_with_replayed_noise(rng, monkeypatch, n_modalities, shape):
    feats = [rng.randn(*shape, C).astype(np.float32) for _ in range(n_modalities)]
    noise = [rng.randn(*shape, HIDDEN).astype(np.float32) for _ in range(n_modalities)]
    jm = JaxMI(HIDDEN, n_modalities)
    variables = fill_variables(
        jax.eval_shape(lambda *f: jm.init({"params": jax.random.PRNGKey(0),
                                           "mi": jax.random.PRNGKey(1)}, *f), *feats), seed=3)

    draws = iter(noise)
    monkeypatch.setattr(jax.random, "normal", lambda key, shp, dtype: jnp.asarray(next(draws)))
    loss, (g_params, *g_feats) = jax.value_and_grad(
        lambda p, *f: jm.apply({"params": p}, *f, rngs={"mi": jax.random.PRNGKey(2)}),
        argnums=tuple(range(1 + n_modalities)))(variables["params"], *feats)
    ref_params = to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, g_params)})

    model = port_mi.MutualInfoReg(C, HIDDEN, n_modalities, n_spatial=len(shape) - 1)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in to_torch_state_dict(variables).items()})
    draws = iter(noise)
    monkeypatch.setattr(port_mi, "draw_noise",
                        lambda shp, generator, device: torch.from_numpy(next(draws)))
    leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = model(*leaves, generator=None)
    out.backward()

    _close(out.item(), loss, "loss")
    assert float(loss) != 0.0
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), ref_params[name], name)
    for i, (t, ref) in enumerate(zip(leaves, g_feats)):
        _close(t.grad.numpy(), ref, f"feature {i}")


def test_mi_noise_comes_from_the_generator():
    model = port_mi.MutualInfoReg(C, HIDDEN, 2, n_spatial=2)
    feats = [torch.randn(2, 5, 6, C) for _ in range(2)]
    a = model(*feats, generator=torch.Generator().manual_seed(5))
    b = model(*feats, generator=torch.Generator().manual_seed(5))
    c = model(*feats, generator=torch.Generator().manual_seed(6))
    assert a.item() == b.item() != c.item()
