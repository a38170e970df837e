"""The port's optimizer against the JAX package's ``optim.py``: every
schedule step by step against ``make_lr_schedule`` (the JAX schedules
evaluate in float32: rtol 1e-5, atol 1e-7 x the initial rate), and three
optimizer steps against ``optimizer_factory`` on the same parameter tree and
gradients, with weight and bias decay and the frozen MDTA ``temperature`` (Adam and SGD
with momentum). Parameters rtol 1e-5, atol 1e-7."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from rpeflow_tpu.compat.torch_loader import to_torch_state_dict
from rpeflow_tpu.nn.mdta import CrossTransformerBlock as JaxBlock
from rpeflow_tpu.train.config import ConfigNode
from rpeflow_tpu.train.optim import make_lr_schedule as jax_schedule
from rpeflow_tpu.train.optim import optimizer_factory as jax_optimizer_factory
from rpeflow_tpu_torch.nn.mdta import CrossTransformerBlock
from rpeflow_tpu_torch.train.optim import make_lr_schedule, optimizer_factory
from torch_port_utils import fill_variables

SCHEDULES = [
    {"scheduler": "MultiStepLR", "init_value": 4e-4, "decay_rate": 0.5,
     "decay_milestones": [2, 5]},
    {"scheduler": "StepLR", "init_value": 1e-3, "decay_rate": 0.1, "decay_milestones": 3},
    {"scheduler": "OneCycleLR", "init_value": 1e-3},
]


def _training(lr, optimizer="adam"):
    return ConfigNode({"max_epochs": 8, "optimizer": optimizer, "lr": lr,
                       "weight_decay": 1e-2, "bias_decay": 1e-3})


@pytest.mark.parametrize("lr", SCHEDULES, ids=lambda d: d["scheduler"])
def test_schedule_matches_jax_step_by_step(lr):
    cfg = _training(lr)
    sched, gran = make_lr_schedule(cfg, steps_per_epoch=7)
    ref, ref_gran = jax_schedule(cfg, steps_per_epoch=7)
    assert gran == ref_gran
    for step in range(8 * 7 + 3):
        np.testing.assert_allclose(sched(step), float(ref(jnp.int32(step))), rtol=1e-5,
                                   atol=1e-7 * lr["init_value"], err_msg=f"step {step}")


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_three_steps_match_jax(rng, optimizer):
    lr = dict(SCHEDULES[0], momentum=0.9)
    cfg = _training(lr, optimizer)
    jm = JaxBlock(8, 2)
    x = rng.randn(1, 4, 5, 8).astype(np.float32)
    params = fill_variables(jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a, a), x),
                            seed=0)["params"]
    grads = [jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
             for _ in range(3)]

    tx, _ = jax_optimizer_factory(cfg, params, steps_per_epoch=1)
    state = tx.init(params)
    ref = params
    for g in grads:
        updates, state = tx.update(g, state, ref)
        ref = optax.apply_updates(ref, updates)
    ref = to_torch_state_dict({"params": jax.tree_util.tree_map(np.asarray, ref)})

    block = CrossTransformerBlock(8, 2, n_spatial=2)
    block.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in to_torch_state_dict({"params": params}).items()})
    opt = optimizer_factory(cfg, block, steps_per_epoch=1)
    named = dict(block.named_parameters())
    for g in grads:
        for name, val in to_torch_state_dict({"params": g}).items():
            named[name].grad = torch.from_numpy(np.array(val))
        opt.step()
    assert opt.step_count == 3
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)
    start = to_torch_state_dict({"params": params})
    np.testing.assert_array_equal(named["attn.temperature"].detach().numpy(),
                                  start["attn.temperature"])
