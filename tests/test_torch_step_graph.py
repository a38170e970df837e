"""The train step as a CUDA graph (``rpeflow_tpu_torch/train/graph.py``).

On the CPU: the engagement rule (eager on CPU parameters and inside a
process group), the MI noise plan against the eager draws on a CPU
generator (bitwise), the shape-keyed device constants of ``ops/interp.py``
and ``model/core.py`` against the values built inline (bitwise), and an
optimizer state saved by the capturable Adam loaded into the CPU's Adam.

On the card (marked ``cuda``; they skip without a CUDA device, and import
no JAX):

    RPEFLOW_TEST_TPU=1 python -m pytest -m cuda tests/test_torch_step_graph.py

at reduced FT3D and DSEC sizes (batch 2, 128x192, 2048 points, MI on):
four graphed steps against three runs of four eager steps from the same
weights, batches and generator seed, for the summaries, parameters, Adam's
state and the batch-norm buffers: each group's relative norm of the
difference to the nearest eager run within twice the largest between two
eager runs (measured in the test, ``chip_smoke.eager_spread``); the MI noise of every replay bitwise equal to
the eager draws; the step counter at 1 eager, 1 capture and 2 replays; the
kernel launches of each step equal to the eager step's; a second batch
shape with its own graph and a third run eagerly; ``load_state_dict``
dropping the graphs and loading a plain Adam's state.
"""

import copy

import pytest
import torch
import torch.nn as nn

from chip_smoke import eager_spread, step_state
from rpeflow_tpu_torch.flagship import (
    dsec_training_cfg,
    make_batch,
    make_dsec_batch,
    model_cfg,
    training_cfg,
)
from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
from rpeflow_tpu_torch.model.core import level_scale
from rpeflow_tpu_torch.nn import mutual_info
from rpeflow_tpu_torch.ops import _cuda
from rpeflow_tpu_torch.ops.geometry import CameraInfo
from rpeflow_tpu_torch.ops.interp import _ac_taps, ac_taps_on, flow_scale, resize_bilinear_ac
from rpeflow_tpu_torch.parallel.dryrun import free_port
from rpeflow_tpu_torch.train import graph
from rpeflow_tpu_torch.train.optim import Optimizer, optimizer_factory
from rpeflow_tpu_torch.train.state import eager_train_step, train_step
from torch_port_utils import cuda_device  # noqa: F401

REDUCED = dict(b=2, h=128, w=192, n=2048, event_ch=20)
REDUCED_SAMPLES = (1024, 512, 256, 128, 64)
SEED = 11
#: configuration -> (loss order, training block, batch maker)
CONFIGS = {"ft3d": ("l2", training_cfg, make_batch),
           "dsec": ("l1", dsec_training_cfg, make_dsec_batch)}


def _linear_and_adam():
    model = nn.Linear(3, 2)
    return model, optimizer_factory(training_cfg(), model, steps_per_epoch=10)


def _stub_body(update):
    update()
    return ["loss"], torch.zeros(1)


# ---------------------------------------------------------------- the CPU


def test_engagement_is_eager_on_the_cpu():
    model, opt = _linear_and_adam()
    assert not opt.capturable
    assert graph.eager_reason(model, opt) == "cpu"
    graph.reset_step_counts()
    keys, _ = graph.run(model, opt, {"x": torch.zeros(1)}, None, True,
                        lambda bt, gen, update: _stub_body(update))
    assert keys == ["loss"] and opt.step_count == 1 and opt.graphs is None
    assert graph.STEPS == dict(graph.STEPS, eager_cpu=1) and sum(graph.STEPS.values()) == 1


def test_engagement_is_eager_in_a_process_group():
    import torch.distributed as dist

    model, opt = _linear_and_adam()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        assert graph.eager_reason(model, opt) == "distributed"
    finally:
        dist.destroy_process_group()
    assert graph.eager_reason(model, opt) == "cpu"


def test_noise_plan_draws_what_the_eager_draws_draw():
    shapes = [(2, 5, 7, 16), (2, 300, 16), (3, 4, 4, 16), (2, 300, 16)]
    eager_gen, plan_gen = (torch.Generator().manual_seed(5) for _ in range(2))
    plan = mutual_info.NoisePlan()
    with mutual_info.recording(plan):  # an eager step: draws as always, notes the shapes
        learned = [mutual_info.draw_noise(s, plan_gen, "cpu") for s in shapes]
    first = [mutual_info.draw_noise(s, eager_gen, "cpu") for s in shapes]
    assert plan.shapes == shapes and all(torch.equal(a, b) for a, b in zip(learned, first))
    plan.allocate("cpu")
    with mutual_info.recording(plan):  # the capture: each draw takes its buffer
        served = [mutual_info.draw_noise(s, None, "cpu") for s in shapes]
    assert plan.served == len(shapes)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(served, plan.buffers))
    for _ in range(2):  # two replays from one generator
        eager = [mutual_info.draw_noise(s, eager_gen, "cpu") for s in shapes]
        plan.draw(plan_gen)
        for e, b in zip(eager, plan.buffers):
            assert torch.equal(e, b)
    assert torch.equal(eager_gen.get_state(), plan_gen.get_state())
    plan.allocate("cpu")
    with pytest.raises(RuntimeError, match="not in the eager step's plan"):
        with mutual_info.recording(plan):
            mutual_info.draw_noise((2, 5, 7, 8), None, "cpu")


@pytest.mark.parametrize("n_in,n_out", [(24, 48), (5, 1), (135, 144), (1, 3)])
def test_resize_constants_equal_the_inline_values(n_in, n_out):
    with torch.inference_mode():  # an eval forward builds them first
        i0, i1, w1, w0 = ac_taps_on(n_in, n_out, torch.device("cpu"), torch.float32)
    ri0, ri1, rw1 = _ac_taps(n_in, n_out)
    for got, ref in ((i0, torch.from_numpy(ri0)), (i1, torch.from_numpy(ri1)),
                     (w1, torch.from_numpy(rw1).float()), (w0, torch.from_numpy(1.0 - rw1))):
        assert not got.is_inference() and got.dtype == ref.dtype and torch.equal(got, ref)
    x = torch.randn(2, n_in, 7, 3, requires_grad=True)
    out = resize_bilinear_ac(x, n_out, 9)
    j0, j1, wx = _ac_taps(7, 9)
    ref = x[:, ri0] * torch.from_numpy(1.0 - rw1)[None, :, None, None] \
        + x[:, ri1] * torch.from_numpy(rw1)[None, :, None, None]
    ref = ref[:, :, j0] * torch.from_numpy(1.0 - wx)[None, None, :, None] \
        + ref[:, :, j1] * torch.from_numpy(wx)[None, None, :, None]
    assert torch.equal(out, ref)
    out.sum().backward()  # the constants may be saved for the backward


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scale_constants_equal_the_inline_values(dtype):
    got = flow_scale(135, 240, 540, 960, torch.device("cpu"), dtype)
    ref = torch.tensor([960 / 240, 540 / 135], dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, ref)
    cam = CameraInfo("parallel", 18, 30, None, 14.5, 8.5)
    ref = torch.tensor([(60 - 1) / (30 - 1), (36 - 1) / (18 - 1)], dtype=torch.float32)
    assert torch.equal(level_scale(36, 60, cam, torch.device("cpu")), ref)


def test_a_capturable_adam_state_loads_into_the_cpu_adam():
    """A state as the card's capturable Adam saves it (device-tensor lr,
    ``capturable``, float32 step tensors) continues the CPU's Adam exactly."""
    torch.manual_seed(0)
    ref_model, ref_opt = _linear_and_adam()
    model, opt = _linear_and_adam()
    model.load_state_dict(ref_model.state_dict())
    grads = [[torch.randn_like(p) for p in ref_model.parameters()] for _ in range(3)]

    def step(m, o, g):
        for p, gp in zip(m.parameters(), g):
            p.grad = gp.clone()
        o.step()

    for g in grads[:2]:
        step(ref_model, ref_opt, g)
    saved = copy.deepcopy(ref_opt.state_dict())
    for group in saved["optimizer"]["param_groups"]:
        group.update(capturable=True, lr=torch.tensor(group["lr"], dtype=torch.float32))
    for s in saved["optimizer"]["state"].values():
        s["step"] = s["step"].to(torch.float32)
    model.load_state_dict(ref_model.state_dict())
    opt.graphs = graph.StepGraphs()
    opt.load_state_dict(saved)
    assert opt.graphs is None and opt.step_count == 2 and not opt.capturable
    assert all(isinstance(g["lr"], float) for g in opt.optimizer.param_groups)
    step(ref_model, ref_opt, grads[2])
    step(model, opt, grads[2])
    for p, q in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------- the card


def _setup(dev, config, amp=False):
    order, training, _ = CONFIGS[config]
    model = seeded_init_(RPEFlow(model_cfg(order), REDUCED_SAMPLES, amp=amp), SEED)
    return model.to(dev).train(), training


def _batches(dev, config, count, **shape):
    make = CONFIGS[config][2]
    return [make(SEED + 1 + i, device=dev, targets=True, **dict(REDUCED, **shape))
            for i in range(count)]


def _run(model, training, batches, step, record_noise=False):
    """Steps of a fresh optimizer and MI generator over ``batches``: the
    summaries, launches and (``record_noise``) MI draws of each step, and the
    optimizer."""
    opt = optimizer_factory(training(), model, steps_per_epoch=100)
    gen = torch.Generator(device=model.pwc_fusion_core.conv_last_2d.weight.device)
    gen.manual_seed(SEED)
    summaries, launches, noise = [], [], []
    draw = mutual_info.draw_noise

    def recorded(shape, generator, device):
        out = draw(shape, generator, device)
        noise[-1].append(out.clone())
        return out

    for bt in batches:
        noise.append([])
        _cuda.reset_launch_counts()
        if record_noise:
            mutual_info.draw_noise = recorded
        try:
            summaries.append(step(model, opt, bt, gen))
        finally:
            mutual_info.draw_noise = draw
        torch.cuda.synchronize()
        launches.append(dict(_cuda.LAUNCHES))
    return summaries, launches, noise, opt


@pytest.mark.cuda
@pytest.mark.parametrize("config,amp", [("ft3d", False), ("dsec", False), ("ft3d", True)])
def test_graphed_steps_match_eager_steps(cuda_device, config, amp):
    start, training = _setup(cuda_device, config, amp)
    batches = _batches(cuda_device, config, 4)
    runs = []
    for i, step in enumerate((eager_train_step,) * 3 + (train_step,)):
        model = copy.deepcopy(start)
        graph.reset_step_counts()
        summaries, launches, noise, opt = _run(model, training, batches, step,
                                               record_noise=i == 0)
        runs.append((summaries, launches, noise, step_state(model, opt), opt, dict(graph.STEPS)))
    eager, graphed = runs[0], runs[3]
    assert graphed[5] == dict(graphed[5], eager_first_sight=1, capture=1, replay=2)
    assert sum(graphed[5].values()) == 4
    assert all(s == eager[1][0] for s in graphed[1]), (graphed[1], eager[1])
    # the MI noise the last replay read, bitwise the eager draws of that step
    (g,) = graphed[4].graphs.graphs.values()
    assert len(g.plan.buffers) == len(eager[2][-1]) > 0
    for buf, ref in zip(g.plan.buffers, eager[2][-1]):
        assert torch.equal(buf, ref)
    spread = eager_spread([(r[0], r[3]) for r in runs[:3]], (graphed[0], graphed[3]))
    print(f"{config} amp={amp}: (eager vs eager, graphed vs nearest eager) {spread}")
    assert all(got <= 2 * tol for tol, got in spread.values()), spread


@pytest.mark.cuda
def test_a_graph_per_batch_shape_and_a_third_shape_eager(cuda_device):
    model, training = _setup(cuda_device, "ft3d")
    opt = optimizer_factory(training(), model, steps_per_epoch=100)
    gen = torch.Generator(device=cuda_device).manual_seed(SEED)
    shapes = [{}, {"b": 1}, {"h": 192, "w": 256}]
    graph.reset_step_counts()
    for shape in shapes:
        for bt in _batches(cuda_device, "ft3d", 2, **shape):
            train_step(model, opt, bt, gen)
    assert len(opt.graphs.graphs) == graph.MAX_GRAPHS == 2
    assert graph.STEPS == dict(graph.STEPS, eager_first_sight=3, capture=2,
                               eager_graphs_full=1, replay=0)
    for bt in _batches(cuda_device, "ft3d", 1, b=1):
        summary = train_step(model, opt, bt, gen)
    assert graph.STEPS["replay"] == 1 and all(torch.isfinite(torch.tensor(list(
        summary.values()))))


@pytest.mark.cuda
def test_load_state_dict_drops_the_graphs_and_loads_a_plain_adam_state(cuda_device):
    model, training = _setup(cuda_device, "dsec")
    opt = optimizer_factory(training(), model, steps_per_epoch=100)
    gen = torch.Generator(device=cuda_device).manual_seed(SEED)
    batches = _batches(cuda_device, "dsec", 3)
    for bt in batches[:2]:
        train_step(model, opt, bt, gen)
    assert opt.capturable and len(opt.graphs.graphs) == 1
    lr = opt.optimizer.param_groups[0]["lr"]
    saved = copy.deepcopy(opt.state_dict())
    # as the CPU's plain Adam saves it: float lr, no capturable, steps on the host
    for group in saved["optimizer"]["param_groups"]:
        group.update(capturable=False, lr=float(group["lr"]))
    for s in saved["optimizer"]["state"].values():
        s["step"] = s["step"].cpu()
    plain = Optimizer(opt.optimizer, opt.schedule)  # the same torch optimizer, new graphs
    plain.load_state_dict(saved)
    assert opt.graphs is not None and plain.graphs is None and plain.capturable
    assert all(torch.is_tensor(g["lr"]) and g["lr"].is_cuda
               for g in plain.optimizer.param_groups)
    assert all(s["step"].is_cuda and s["step"].dtype == torch.float32
               for s in plain.optimizer.state.values())
    opt.load_state_dict(opt.state_dict())
    assert opt.graphs is None and opt.optimizer.param_groups[0]["lr"] is not lr
    graph.reset_step_counts()
    for bt in batches:
        summary = train_step(model, opt, bt, gen)
    assert graph.STEPS == dict(graph.STEPS, eager_first_sight=1, capture=1, replay=1)
    assert all(torch.isfinite(torch.tensor(list(summary.values()))))
