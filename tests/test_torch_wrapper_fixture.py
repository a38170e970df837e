"""The port's full wrapper against the recorded upstream outputs.

Inputs, configuration and weights are those of tests/test_wrapper_parity.py
(288x480 images, resized inside to 320x512; 8192-point clouds; IDS on;
losses and metrics on; the JAX ``init`` with ``PRNGKey(0)``), and
``tests/fixtures/wrapper_parity_288x480.npz`` holds what the upstream torch
model computed on them. The port runs in evaluation mode with the losses on,
as the fixture was recorded, and is held to it with the same tolerance model
(flows: >= 99.5% of elements within ``2e-2 + 1e-3 |ref|`` and mean
``|d| < 2e-2``; loss_2d, loss_3d, epe2d, epe3d: rtol 2e-3).

The JAX parameters are made by ``init`` on a small input: flax draws each
parameter from its module path, not from the input, so the values are those
of the full-size ``init``; only the parameter shapes depend on the
configuration.
"""

import numpy as np
import pytest
import torch

import jax

from rpeflow_tpu.model import RPEFlow as JaxRPEFlow
from rpeflow_tpu_torch.compat import load_jax_variables
from rpeflow_tpu_torch.model import RPEFlow
from test_wrapper_parity import FIXTURE, MODEL_CFG, SAMPLES, _inputs
from torch_port_utils import assert_flow_close, make_inputs


def _jax_variables():
    """The parameters of test_wrapper_parity's ``init`` (PRNGKey(0), MI
    heads included), from a 128x128, 512-point input."""
    small = make_inputs(0, b=1, h=128, w=128, n=512, event_ch=20)
    model = JaxRPEFlow(cfgs=MODEL_CFG, n_samples_list=(256, 128, 64, 32, 16))
    return jax.jit(lambda b: model.init(
        {"params": jax.random.PRNGKey(0), "mi": jax.random.PRNGKey(1)},
        b, train=False, compute_mi=True, compute_loss=True))(small)


@pytest.mark.slow
def test_port_matches_recorded_upstream_wrapper():
    ref = dict(np.load(FIXTURE))
    model = RPEFlow(MODEL_CFG, SAMPLES)
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, _jax_variables()),
                       strict=True)
    inputs = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    with torch.no_grad():
        outputs, aux = model(inputs, compute_loss=True)
    summary = aux["scalar_summary"]

    assert_flow_close(outputs["flow_2d"].numpy(), ref["flow_2d"],
                      "final 2D flow (full wrapper, 288x480)")
    assert_flow_close(outputs["flow_3d"].numpy(), ref["flow_3d"],
                      "final 3D flow (full wrapper, 8192 points)")
    for key in ("loss_2d", "loss_3d", "epe2d", "epe3d"):
        np.testing.assert_allclose(float(summary[key]), float(ref[key]), rtol=2e-3,
                                   err_msg=key)
