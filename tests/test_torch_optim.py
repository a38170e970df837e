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


def test_param_groups_match_jax_group_of_on_the_flagship_model():
    """Every parameter of the pretrain.yaml model lands in the group that
    JAX ``_group_of`` gives its flax path (by the leaf name): the
    ``weight_net`` MLPs' biases are biases, not decayed weights."""
    from rpeflow_tpu.model import RPEFlow as JaxRPEFlow
    from rpeflow_tpu.train.config import load_config as jax_load_config
    from rpeflow_tpu.train.optim import _group_of
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.train.config import load_config
    from rpeflow_tpu_torch.train.optim import param_groups
    from torch_port_utils import make_inputs

    cfg = "conf/train/pretrain.yaml"
    n_samples = (512, 256, 128, 64, 32)
    jm = JaxRPEFlow(cfgs=jax_load_config(cfg).model, n_samples_list=n_samples)
    shapes = jax.eval_shape(
        lambda x: jm.init({"params": jax.random.PRNGKey(0), "mi": jax.random.PRNGKey(1)},
                          x, train=True, compute_mi=True),
        make_inputs(0, b=1, h=128, w=128, n=1024, event_ch=20))["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    expected = {}
    for path, leaf in flat:
        keys = tuple(k.key for k in path)
        one = {}
        node = one
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.zeros(leaf.shape, np.float32)
        (name,) = to_torch_state_dict({"params": one})
        expected[name] = _group_of(keys)

    model = seeded_init_(RPEFlow(load_config(cfg).model, n_samples), seed=0)
    weights, biases = param_groups(model)
    group = {id(p): "weights" for p in weights}
    group.update({id(p): "biases" for p in biases})
    got = {name: group.get(id(p), "frozen") for name, p in model.named_parameters()}
    assert got.keys() == expected.keys()
    assert sum(g == "biases" and "weight_net" in n for n, g in expected.items()) == 44
    wrong = sorted(n for n in got if got[n] != expected[n])
    assert wrong == [], f"{len(wrong)} parameters in the wrong group: {wrong[:5]}"
