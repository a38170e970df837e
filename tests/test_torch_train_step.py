"""One training step of the port against the JAX package's ``make_train_step``.

Tiny model of tests/test_torch_model.py (64x64, 64 points, n_samples
(32, 16), k=8), batch 2, l2 losses, MultiStep Adam with weight decay, MI
off so both steps are deterministic, weights ``fill_variables`` seeds 1-5.
Bounds (those of tests/test_segmented_train.py, where two JAX steps are
held to each other): loss rtol 1e-4; grad_norm rtol 2e-3; per-leaf gradients
``|d| <= 2e-3 * max(|g|max, 1) + 1e-4`` (gradients, not post-Adam
parameters: Adam's first step is ~sign(g) and would amplify sum-order noise
on near-zero entries), except that a bias feeding a batch norm (exact
gradient 0, ``chip_smoke.pre_norm_biases``) is held on both sides to
``|g| <= 1e-6`` of the model's largest gradient entry (at most 3.1e-7 read
over the five seeds); updated batch statistics rtol 1e-4, atol 1e-6.
With MI on (port only, its noise differs by construction): finite values,
``mi_loss != 0``, parameters move and the frozen ``temperature`` does not.

The JAX step replays the port's (leaky) ReLU signs, in call order. The two
frameworks' f32 forwards differ in their last bits (encoder features by
up to 5e-5 of ~6 at seed 1), and a pre-activation that near 0 takes the other
branch in each: with seed 1, JAX's own signs differ from the port's at 3 of
1,965,536, with inputs of ~5e-6, and those three moved the first 2-D
estimator conv's weight gradient by 23x the per-leaf bound and the pyramid
convs behind it by up to 17x. Neither f32 run is the exact one: a float64
run of the port differs from JAX's f32 signs at 4 and from the port's f32
signs at 1 (seeds 1-5: at most 9 and 4). Held to one set of signs, each
framework's own arithmetic agrees to the bounds above on every seed. JAX's
own signs may differ from the replayed ones in at most ``SIGN_FLIP_BOUND``
of them (at most 5 of 1,965,536 read over the five seeds).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen
import jax
import jax.numpy as jnp
import optax

from chip_smoke import pre_norm_biases
from rpeflow_tpu.compat.torch_loader import to_torch_state_dict
from rpeflow_tpu.model import RPEFlow as JaxRPEFlow
from rpeflow_tpu.train.config import ConfigNode
from rpeflow_tpu.train.optim import optimizer_factory as jax_optimizer_factory
from rpeflow_tpu.train.state import create_train_state, make_train_step
from rpeflow_tpu_torch.compat import load_jax_variables
from rpeflow_tpu_torch.model import RPEFlow
from rpeflow_tpu_torch.train.optim import optimizer_factory
from rpeflow_tpu_torch.train.state import train_step
from torch_port_utils import fill_variables, make_inputs, small_cfg_dict

N_SAMPLES = (32, 16)
LOSS = {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2"}
TRAINING = {"max_epochs": 10, "optimizer": "adam",
            "lr": {"scheduler": "MultiStepLR", "init_value": 1e-4, "decay_rate": 0.5,
                   "decay_milestones": [5]},
            "weight_decay": 1e-6, "bias_decay": 0.0}
SEEDS = (1, 2, 3, 4, 5)
# share of JAX's own activation signs that may differ from the port's
SIGN_FLIP_BOUND = 1e-5


def _batch():
    batch = make_inputs(0, targets=True)
    batch["flow_3d"] = np.concatenate(
        [batch["flow_3d"], 1.0 - batch.pop("occ_mask_3d")[..., None]], -1)
    return batch


def _cfg():
    return ConfigNode(dict(small_cfg_dict(), loss2d=LOSS, loss3d=LOSS))


def _variables(jax_model, batch, seed):
    shapes = jax.eval_shape(
        lambda x: jax_model.init({"params": jax.random.PRNGKey(0), "mi": jax.random.PRNGKey(1)},
                                 x, train=True, compute_mi=True, compute_loss=True), batch)
    return fill_variables(shapes, seed=seed)


def _port_model(cfg, variables):
    model = RPEFlow(cfg, N_SAMPLES)
    load_jax_variables(model, variables, strict=True)
    return model.train()


def _port_step_recording_signs(model, opt, batch):
    """The port's train step; returns its summary and the sign mask
    ``x > 0`` of every (leaky) ReLU input of the forward, in call order (the
    backward's reruns of checkpointed units are not recorded: JAX traces its
    remat units once)."""
    signs, in_forward = [], [False]
    leaky_relu, relu, forward = F.leaky_relu, F.relu, model.forward

    def record(x):
        if in_forward[0]:
            signs.append((x.detach() > 0).numpy())

    def rec_leaky_relu(x, negative_slope=0.01, inplace=False):
        record(x)
        return leaky_relu(x, negative_slope)

    def rec_relu(x, inplace=False):
        record(x)
        return relu(x)

    def rec_forward(*args, **kwargs):
        in_forward[0] = True
        try:
            return forward(*args, **kwargs)
        finally:
            in_forward[0] = False

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "leaky_relu", rec_leaky_relu)
        mp.setattr(F, "relu", rec_relu)
        mp.setattr(model, "forward", rec_forward)
        out = train_step(model, opt, {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                         compute_mi=False)
    return out, signs


def _jax_step(jax_model, tx, flips):
    """``make_train_step`` (MI off) with its (leaky) ReLUs taking the signs
    passed in, in call order; JAX's own disagreements are written to
    ``flips`` by call. Also returns the gradients (``make_train_step`` reports
    ``optax.global_norm(grads)``; it hands them back here, so one compiled
    step yields both)."""

    def step(state, batch, key, signs):
        pos = iter(enumerate(signs))

        def take(x):
            i, mask = next(pos)
            assert mask.shape == x.shape, (mask.shape, x.shape)
            # a remat unit reruns its callbacks in the backward: keyed by call
            jax.debug.callback(lambda n, i=i: flips.__setitem__(i, int(n)),
                               jnp.sum(mask != (x > 0)))
            return mask

        global_norm = optax.global_norm
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax.linen, "leaky_relu",
                       lambda x, negative_slope=0.01: jnp.where(take(x), x, negative_slope * x))
            mp.setattr(flax.linen, "relu", lambda x: jnp.where(take(x), x, jnp.zeros_like(x)))
            mp.setattr(optax, "global_norm", lambda g: {"norm": global_norm(g), "grads": g})
            new_state, ref = make_train_step(jax_model, tx, compute_mi=False)(state, batch, key)
        assert next(pos, None) is None, "JAX ran fewer activations than the port"
        return new_state, ref

    return jax.jit(step)


@pytest.fixture(scope="module")
def setup():
    cfg, batch = _cfg(), _batch()
    jax_model = JaxRPEFlow(cfgs=cfg, n_samples_list=N_SAMPLES)
    tcfg = ConfigNode(TRAINING)
    tx, _ = jax_optimizer_factory(tcfg, _variables(jax_model, batch, 1)["params"],
                                  steps_per_epoch=10)
    flips = {}
    return cfg, batch, jax_model, tcfg, tx, _jax_step(jax_model, tx, flips), flips


@pytest.fixture(scope="module", params=SEEDS)
def steps(request, setup):
    """``(JAX summary, port summary, JAX gradients and updated batch stats
    under the port's state_dict names, port model after its step)``."""
    cfg, batch, jax_model, tcfg, tx, jax_step, flips = setup
    variables = _variables(jax_model, batch, request.param)

    model = _port_model(cfg, variables)
    opt = optimizer_factory(tcfg, model, steps_per_epoch=10)
    out, signs = _port_step_recording_signs(model, opt, batch)

    flips.clear()
    new_state, ref = jax_step(create_train_state(variables, tx),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jax.random.PRNGKey(0), tuple(jnp.asarray(s) for s in signs))
    jax.block_until_ready(ref)
    jax.effects_barrier()
    n_signs = sum(s.size for s in signs)
    n_flips = sum(flips.values())
    assert sorted(flips) == list(range(len(signs))), (len(flips), len(signs))
    assert n_flips <= SIGN_FLIP_BOUND * n_signs, (n_flips, n_signs)
    print(f"seed {request.param}: JAX's own signs differ from the port's at {n_flips} "
          f"of {n_signs}")
    ref_grads = ref["grad_norm"]["grads"]
    ref = dict(ref, grad_norm=ref["grad_norm"]["norm"])
    ref_state = to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, ref_grads),
                                     "batch_stats": jax.tree_util.tree_map(
                                         np.asarray, new_state.batch_stats)})
    return ({k: float(v) for k, v in ref.items()}, out, ref_state, model)


def test_loss_and_grad_norm_match_jax(steps):
    ref, out, _, _ = steps
    for key in ("loss", "loss_2d", "loss_3d"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(out["grad_norm"], ref["grad_norm"], rtol=2e-3)
    assert out["mi_loss"] == ref["mi_loss"] == 0.0


def test_gradients_match_jax_per_leaf(steps):
    _, _, ref_state, model = steps
    params = dict(model.named_parameters())
    names = [k for k in ref_state if not k.endswith(("running_mean", "running_var",
                                                     "num_batches_tracked"))]
    assert sorted(names) == sorted(params)
    zero_grad = pre_norm_biases(model)
    assert zero_grad
    g_max = max(float(np.abs(ref_state[name]).max()) for name in names)
    for name in names:
        g_ref = ref_state[name]
        g = params[name].grad
        g = np.zeros_like(g_ref) if g is None else g.numpy()
        if name in zero_grad:
            noise = max(float(np.abs(g).max()), float(np.abs(g_ref).max()))
            assert noise <= 1e-6 * g_max, (name, noise, g_max)
            continue
        d = float(np.abs(g - g_ref).max())
        scale = max(float(np.abs(g_ref).max()), 1.0)
        assert d <= 2e-3 * scale + 1e-4, (name, d, scale)


def test_batch_stats_match_jax(steps):
    _, _, ref_state, model = steps
    buffers = dict(model.named_buffers())
    keys = [k for k in ref_state if k.endswith(("running_mean", "running_var"))]
    assert keys and len(keys) == sum(k.endswith(("running_mean", "running_var"))
                                     for k in buffers)
    for key in keys:
        np.testing.assert_allclose(buffers[key].numpy(), ref_state[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def test_step_with_mi_is_finite_and_moves_parameters():
    cfg, batch = _cfg(), _batch()
    variables = _variables(JaxRPEFlow(cfgs=cfg, n_samples_list=N_SAMPLES), batch, 2)
    model = _port_model(cfg, variables)
    opt = optimizer_factory(ConfigNode(TRAINING), model, steps_per_epoch=10)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    out = train_step(model, opt, {k: torch.from_numpy(v) for k, v in batch.items()},
                     torch.Generator().manual_seed(3), compute_mi=True)
    assert all(np.isfinite(v) for v in out.values()), out
    assert out["mi_loss"] != 0.0
    after = dict(model.named_parameters())
    assert float((after["pwc_fusion_core.conv_last_2d.weight"]
                  - before["pwc_fusion_core.conv_last_2d.weight"]).abs().max()) > 0
    temps = [k for k in before if k.endswith("temperature")]
    assert temps
    for k in temps:
        assert after[k].grad is not None
        torch.testing.assert_close(after[k].detach(), before[k], rtol=0, atol=0)
