"""The whole eval slice: the port's RPEFlow forward and metric sums against
the JAX package's, with the same seeded weights and inputs.

Small model: 64x64 images, 64 points, n_samples (32, 16) (3 pyramid levels,
2 decode levels), k=8, IDS on, batch 2. The JAX variables come from
``jax.eval_shape(init)`` filled with numpy (a real ``init`` is minutes on
CPU) and reach the port through ``load_jax_variables``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rpeflow_tpu.model import RPEFlow as JaxRPEFlow
from rpeflow_tpu.train.config import ConfigNode
from rpeflow_tpu.train.evaluator import _metric_sums as jax_metric_sums
from rpeflow_tpu_torch.compat import load_jax_variables
from rpeflow_tpu_torch.model import RPEFlow
from rpeflow_tpu_torch.train.evaluator import _metric_sums
from torch_port_utils import assert_flow_close, fill_variables, make_inputs, small_cfg_dict

N_SAMPLES = (32, 16)


@pytest.fixture(scope="module")
def slice_outputs():
    cfg = ConfigNode(small_cfg_dict())
    jax_model = JaxRPEFlow(cfgs=cfg, n_samples_list=N_SAMPLES)
    batch = make_inputs(0, targets=True)
    model_in = {k: batch[k] for k in ("images", "pcs", "event_voxel", "intrinsics")}
    shapes = jax.eval_shape(
        lambda x: jax_model.init({"params": jax.random.PRNGKey(0), "mi": jax.random.PRNGKey(1)},
                                 x, train=True, compute_mi=True), model_in)
    variables = fill_variables(shapes, seed=1)

    def fwd(v, x):
        out, _ = jax_model.apply(v, x, train=False, compute_mi=False)
        return out, jax_metric_sums(out, x, True)

    ref, ref_sums = jax.jit(fwd)(variables, {k: jnp.asarray(v) for k, v in batch.items()})

    model = RPEFlow(cfg, N_SAMPLES)
    load_jax_variables(model, variables, strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        out = model({k: tb[k] for k in model_in})
        sums = _metric_sums(out, tb, True)
    return ({k: np.asarray(v) for k, v in ref.items()}, {k: float(v) for k, v in ref_sums.items()},
            {k: v.numpy() for k, v in out.items()}, {k: float(v) for k, v in sums.items()})


@pytest.mark.parametrize("key", ["flow_2d", "flow_3d"])
def test_slice_flow_matches_jax(slice_outputs, key):
    ref, _, out, _ = slice_outputs
    assert np.isfinite(out[key]).all()
    assert_flow_close(out[key], ref[key], f"{key} (64x64, 64 points, 2 decode levels)")


def test_slice_metric_sums_match_jax(slice_outputs):
    _, ref_sums, _, sums = slice_outputs
    assert sums.keys() == ref_sums.keys()
    for key, val in ref_sums.items():
        if key.endswith("counts"):
            assert sums[key] == val, key
        else:
            np.testing.assert_allclose(sums[key], val, rtol=2e-2, atol=1.0, err_msg=key)


def test_flow_metrics_match_jax(rng):
    from rpeflow_tpu.model.rpeflow import flow_metrics as jax_flow_metrics
    from rpeflow_tpu_torch.model import flow_metrics

    batch = make_inputs(2, targets=True)
    f2d = batch["flow_2d"][..., :2] + rng.randn(2, 64, 64, 2).astype(np.float32)
    f3d = batch["flow_3d"] + (rng.randn(2, 64, 3) * 0.05).astype(np.float32)
    t3d = np.concatenate([batch["flow_3d"], batch["occ_mask_3d"][..., None]], -1)
    ref = jax_flow_metrics(f2d, f3d, batch["flow_2d"], t3d)
    out = flow_metrics(*map(torch.from_numpy, (f2d, f3d, batch["flow_2d"], t3d)))
    for key, val in ref.items():
        np.testing.assert_allclose(float(out[key]), float(val), rtol=1e-5, err_msg=key)
