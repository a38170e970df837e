"""The port's data-parallel train step (2 gloo ranks on the CPU, one sample
each) against the JAX package's step on a 2-device CPU mesh (``get_mesh``,
``replicate``, ``shard_batch``, ``jit_sharded(make_train_step)``).

Model, batch, weights (``fill_variables`` seed 1), optimizer and MI (off)
are those of tests/test_torch_train_step.py, and so are the bounds: loss
rtol 1e-4, grad_norm rtol 2e-3, per-leaf gradients ``|d| <= 2e-3 *
max(|g|max, 1) + 1e-4`` (a bias feeding a batch norm held to 1e-6 of the
largest gradient entry on both sides), updated batch statistics rtol 1e-4,
atol 1e-6. The JAX step replays the ranks' (leaky) ReLU signs of the
forward, in call order, as that file's does, JAX's own differing in at most
``SIGN_FLIP_BOUND`` of them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dp_worker
from chip_smoke import pre_norm_biases
from rpeflow_tpu.compat.torch_loader import to_torch_state_dict
from rpeflow_tpu.model import RPEFlow as JaxRPEFlow
from rpeflow_tpu.parallel import get_mesh, replicate, shard_batch
from rpeflow_tpu.train.config import ConfigNode
from rpeflow_tpu.train.optim import optimizer_factory as jax_optimizer_factory
from rpeflow_tpu.train.state import create_train_state
from rpeflow_tpu_torch.model import RPEFlow
from rpeflow_tpu_torch.parallel.dryrun import spawn_ranks
from test_torch_train_step import (
    N_SAMPLES,
    SIGN_FLIP_BOUND,
    TRAINING,
    _batch,
    _cfg,
    _jax_step,
    _port_model,
    _variables,
)

WORLD = 2


def _forward_signs(result):
    """The sign masks a rank's forward recorded, in call order."""
    start, end = result["forward_span"]
    return [t for t in result["tape"][start:end] if t.dtype == torch.bool]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """``(JAX summary, the ranks' results, JAX gradients and updated batch
    statistics under the port's state_dict names, port model)``."""
    tmp = tmp_path_factory.mktemp("dp_jax")
    cfg, batch = _cfg(), _batch()
    jax_model = JaxRPEFlow(cfgs=cfg, n_samples_list=N_SAMPLES)
    variables = _variables(jax_model, batch, 1)
    model = _port_model(cfg, variables)
    spec = {"cfg": cfg.to_dict(), "n_samples": N_SAMPLES, "state": model.state_dict(),
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "training": TRAINING, "seed": 0, "mi": False}
    torch.save(spec, str(tmp / "spec.pt"))
    spawn_ranks(torch_dp_worker.train_step, WORLD, str(tmp / "spec.pt"), str(tmp))
    ranks = [torch.load(str(tmp / f"rank{r}.pt")) for r in range(WORLD)]

    signs = [torch.cat(ts).numpy() for ts in zip(*map(_forward_signs, ranks))]
    mesh = get_mesh(jax.devices()[:WORLD])
    tx, _ = jax_optimizer_factory(ConfigNode(TRAINING), variables["params"],
                                  steps_per_epoch=10)
    flips = {}
    new_state, ref = _jax_step(jax_model, tx, flips, mesh)(
        replicate(create_train_state(variables, tx), mesh), shard_batch(batch, mesh),
        jax.random.PRNGKey(0), tuple(jnp.asarray(s) for s in signs))
    jax.block_until_ready(ref)
    jax.effects_barrier()
    n_signs, n_flips = sum(s.size for s in signs), sum(flips.values())
    assert sorted(flips) == list(range(len(signs))), (len(flips), len(signs))
    assert n_flips <= SIGN_FLIP_BOUND * n_signs, (n_flips, n_signs)
    print(f"JAX's own signs differ from the ranks' at {n_flips} of {n_signs}")
    ref_grads = ref["grad_norm"]["grads"]
    ref = dict(ref, grad_norm=ref["grad_norm"]["norm"])
    ref_state = to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, ref_grads),
                                     "batch_stats": jax.tree_util.tree_map(
                                         np.asarray, new_state.batch_stats)})
    return {k: float(v) for k, v in ref.items()}, ranks, ref_state, RPEFlow(cfg, N_SAMPLES)


def test_two_rank_loss_and_grad_norm_match_jax_mesh(steps):
    ref, ranks, _, _ = steps
    print("2 ranks vs the JAX mesh, relative |d|: " + ", ".join(
        f"{k} {abs(ranks[0]['summary'][k] - ref[k]) / abs(ref[k]):.2e}"
        for k in ("loss", "loss_2d", "loss_3d", "grad_norm")))
    for res in ranks:
        out = res["summary"]
        for key in ("loss", "loss_2d", "loss_3d"):
            np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(out["grad_norm"], ref["grad_norm"], rtol=2e-3)
        assert out["mi_loss"] == ref["mi_loss"] == 0.0


def test_two_rank_gradients_match_jax_mesh_per_leaf(steps):
    _, ranks, ref_state, model = steps
    names = [k for k in ref_state if not k.endswith(("running_mean", "running_var",
                                                     "num_batches_tracked"))]
    assert sorted(names) == sorted(k for k, _ in model.named_parameters())
    zero_grad = pre_norm_biases(model)
    g_max = max(float(np.abs(ref_state[name]).max()) for name in names)
    for res in ranks:
        for name in names:
            g_ref = ref_state[name]
            g = res["grads"].get(name)
            g = np.zeros_like(g_ref) if g is None else g.numpy()
            if name in zero_grad:
                noise = max(float(np.abs(g).max()), float(np.abs(g_ref).max()))
                assert noise <= 1e-6 * g_max, (name, noise, g_max)
                continue
            d = float(np.abs(g - g_ref).max())
            assert d <= 2e-3 * max(float(np.abs(g_ref).max()), 1.0) + 1e-4, (name, d)


def test_two_rank_batch_stats_match_jax_mesh(steps):
    _, ranks, ref_state, _ = steps
    keys = [k for k in ref_state if k.endswith(("running_mean", "running_var"))]
    assert keys
    for res in ranks:
        for key in keys:
            np.testing.assert_allclose(res["buffers"][key].numpy(), ref_state[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)
