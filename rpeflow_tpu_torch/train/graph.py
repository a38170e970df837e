"""The train step as one CUDA graph.

:func:`run` runs a train step's body (``train/state.py : _step``: the
forward with its losses and MI, the backward with its activation
recompute, the gradient norm, the optimizer's update) eagerly or as a
replay of a captured CUDA graph, by what it sees in its inputs:

* eagerly, as it always ran, inside a process group (``distributed``), on
  CPU parameters (``cpu``), or with an optimizer that cannot be captured
  (``not_capturable``: any but the capturable Adam of
  :func:`~.optim.optimizer_factory`);
* otherwise by the step's signature (:func:`signature`: the batch's keys,
  shapes and dtypes, ``compute_mi``, the model's mode and ``amp``, the model
  and the optimizer). Its first sight runs eagerly on the side stream that
  the capture uses (``first_sight``: the kernels' builds, the libraries'
  workspaces, Adam's state); its second copies the batch into the graph's
  input buffers, captures the step and replays it once; later ones copy
  the batch and replay. An optimizer keeps :data:`MAX_GRAPHS` graphs, which
  share one memory pool (a trainer's short last batch has its own); a
  further signature runs eagerly (``graphs_full``).

Every call is one real update on the given batch. Before a replay the step
writes the learning rate into the optimizer's device tensor and draws the
MI noise the captured step reads from the generator, in the eager order
(:class:`~..nn.mutual_info.NoisePlan`), so a replay computes what an eager
step computes. The host's counters move as on an eager step: a replay adds
the kernel launches (``ops/_cuda.py : LAUNCHES``) its capture counted, and
:data:`STEPS` counts captures, replays and eager steps by reason. A replay
opens the span ``rpeflow.train_step.replay``; the phase spans open on eager
steps. After a replay each parameter's ``.grad`` holds that step's gradient.
A :class:`~..utils.flops.FlopCount` counts the operators as they run: a
step's FLOPs on an eager step or a capture, none on a replay.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..nn.mutual_info import NoisePlan, recording
from ..ops import _cuda
from ..parallel.mesh import is_distributed
from ..utils.profile import span

#: graphs an optimizer keeps
MAX_GRAPHS = 2
EAGER_REASONS = ("cpu", "distributed", "not_capturable", "first_sight", "graphs_full")
#: train steps by how they ran; see :func:`reset_step_counts`
STEPS = {"capture": 0, "replay": 0, **{f"eager_{r}": 0 for r in EAGER_REASONS}}

#: ``body(batch, generator, update) -> (summary keys, their values in one
#: tensor)``: one train step, ``update()`` the optimizer's update
Body = Callable[[Dict[str, torch.Tensor], Optional[torch.Generator], Callable[[], None]],
                Tuple[list, torch.Tensor]]


def reset_step_counts() -> None:
    for k in STEPS:
        STEPS[k] = 0


def eager_reason(model: nn.Module, optimizer) -> Optional[str]:
    """Why a step of ``model`` with ``optimizer`` cannot run as a graph
    whatever its signature, or None."""
    if is_distributed():
        return "distributed"
    if not all(p.is_cuda for p in model.parameters()):
        return "cpu"
    if not optimizer.capturable:
        return "not_capturable"
    return None


def signature(model: nn.Module, batch: Dict[str, torch.Tensor], compute_mi: bool) -> tuple:
    return (id(model), model.training, bool(getattr(model, "amp", False)), bool(compute_mi),
            tuple((k, tuple(t.shape), t.dtype, t.device) for k, t in sorted(batch.items())))


class _Graph:
    """A captured step: its graph, input buffers, MI noise, summary, each
    parameter's gradient and the kernel launches of one step."""

    def __init__(self, graph, inputs, plan, keys, values, grads, launches):
        self.graph, self.inputs, self.plan = graph, inputs, plan
        self.keys, self.values, self.grads, self.launches = keys, values, grads, launches


class StepGraphs:
    """An optimizer's captured steps by signature, the signatures seen (with
    the MI draws of their first eager step), the graphs' shared memory pool
    and the graph whose gradients the parameters hold."""

    def __init__(self):
        self.graphs: Dict[tuple, _Graph] = {}
        self.seen: Dict[tuple, NoisePlan] = {}
        self.pool = None
        self.attached: Optional[_Graph] = None


_SIDE: Dict[int, torch.cuda.Stream] = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream that eager steps of graphed training run and capture on."""
    if device.index not in _SIDE:
        _SIDE[device.index] = torch.cuda.Stream(device)
    return _SIDE[device.index]


def _on_side(device, fn):
    current, side = torch.cuda.current_stream(device), side_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = fn()
    current.wait_stream(side)
    return out


def run(model: nn.Module, optimizer, batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator], compute_mi: bool, body: Body):
    """One train step (see the module docstring); returns the summary's
    keys and its values in one tensor."""
    reason = eager_reason(model, optimizer)
    if reason is not None:
        STEPS[f"eager_{reason}"] += 1
        return body(batch, generator, optimizer.step)
    if optimizer.graphs is None:
        optimizer.graphs = StepGraphs()
    cache = optimizer.graphs
    sig = signature(model, batch, compute_mi)
    graph = cache.graphs.get(sig)
    if graph is not None:
        return _replay(cache, graph, model, optimizer, batch, generator)
    if sig not in cache.seen or len(cache.graphs) >= MAX_GRAPHS:
        STEPS["eager_first_sight" if sig not in cache.seen else "eager_graphs_full"] += 1
        cache.attached = None
        plan = NoisePlan()
        cache.seen.setdefault(sig, plan)

        def eager():
            with recording(plan):
                return body(batch, generator, optimizer.step)
        return _on_side(next(model.parameters()).device, eager)
    graph = _capture(cache, cache.seen[sig], model, optimizer, batch, generator, body)
    cache.graphs[sig] = graph
    STEPS["capture"] += 1
    return _launch(cache, graph, model, optimizer, generator)


def _capture(cache: StepGraphs, plan: NoisePlan, model, optimizer, batch, generator,
             body) -> _Graph:
    """Capture the step on copies of ``batch``, its MI noise read from
    buffers for ``plan``'s draws; nothing runs yet. What a replay reads that
    is written before it (the copies, the noise, the learning rate) is
    allocated outside the graph's memory pool."""
    device = next(model.parameters()).device
    inputs = {k: t.clone() for k, t in batch.items()}
    plan.allocate(device)
    before = dict(_cuda.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with recording(plan), torch.cuda.graph(graph, pool=cache.pool, stream=side_stream(device)):
        keys, values = body(inputs, generator, optimizer.optimizer.step)
    if plan.served != len(plan.shapes):
        raise RuntimeError(f"the captured step drew {plan.served} of the eager step's "
                           f"{len(plan.shapes)} MI draws")
    if cache.pool is None:
        cache.pool = graph.pool()
    launches = {k: n - before[k] for k, n in _cuda.LAUNCHES.items() if n != before[k]}
    grads = [p.grad for p in model.parameters()]
    cache.attached = None
    return _Graph(graph, inputs, plan, keys, values, grads, launches)


def _replay(cache, graph: _Graph, model, optimizer, batch, generator):
    for k, t in batch.items():
        graph.inputs[k].copy_(t)
    STEPS["replay"] += 1
    for k, n in graph.launches.items():
        _cuda.LAUNCHES[k] += n
    return _launch(cache, graph, model, optimizer, generator)


def _launch(cache, graph: _Graph, model, optimizer, generator):
    """Set the learning rate, draw the MI noise, replay and count the step."""
    optimizer.set_lr()
    graph.plan.draw(generator)
    with span("rpeflow.train_step.replay"):
        graph.graph.replay()
    optimizer.step_count += 1
    if cache.attached is not graph:
        for p, g in zip(model.parameters(), graph.grads):
            p.grad = g
        cache.attached = graph
    return graph.keys, graph.values
