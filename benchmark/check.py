"""How ``correct`` is decided: the program's outputs against the frozen plain
reference (:mod:`benchmark.reference`), on the same seeded weights, batches
and MI noise, computed on the card in float32 with TF32 off.

Eval cells: a sample of the window's iterations, drawn from the seed. For
each, the reference's forward on the same batch, and the reference's metric
sums of the flows the program returned; the numbers, at the worst sampled
iteration, are

* ``flow_2d.off`` / ``flow_3d.off``: the share of the flow's elements that
  are off, ``|p - r| > 1e-3 (|r| + rms(r))`` (a NaN that the reference does
  not have is off; a shape that differs is all off);
* ``flow_2d.rel`` / ``flow_3d.rel``: the flow's gap in the mean,
  ``||p - r|| / ||r||`` over all its elements;
* ``flow_2d.q90`` / ``flow_3d.q90``: the 90th percentile over the flow's
  elements of ``|p - r| / (|r| + rms(r))``, which a precision lost on
  every element moves and a few elements that part at a near-tie of a
  nearest-neighbour choice do not; ``flow_2d.q50`` / ``flow_3d.q50`` the
  median, which the near-ties move less still;
* ``sums.gap``: the largest gap of the program's metric sums and counts from
  the reference's sums of the program's own flows, ``|p - r|`` over the
  larger of ``|r|`` and the number of elements the sum runs over. The flows
  are held to the reference's flows by the numbers above; this holds the
  sums to the flows they were taken of, so a near-tie that parts a few
  points' flows (and moves the EPE sum of a random-weight 3-D flow of
  hundreds of metres) does not read as a fault of the sums.

The cells compare percentiles and ``sums.gap``; ``off`` and ``rel`` swing
with the near-ties and are printed for calibration only.

Two values that are equal, infinities both overflowed to included (random
weights can grow a 3-D flow past what a float32 EPE squares to), have no
gap; a NaN against a number has an infinite one.

Train cells: the first three steps of the object the window then drives.
The reference follows them from the same weights, batches and MI generator
(its Adam written out). The numbers compared are

* ``loss.gap``: the largest relative gap of a step's loss; ``loss1.gap``
  the first step's alone, before Adam's first update (which moves every
  parameter by about the learning rate, whatever the sign of a gradient
  that is rounding alone) can part the two sides;
* ``grad.gap``: the first gradient as the optimizer takes it (the port's
  worked out from Adam's first moment after one step), by the worst leaf:
  ``|n_p - n_r| / max(n_r, median leaf n_r)`` of the leaves' norms;
* ``change.gap``: the parameters' change over the three steps, by the worst
  leaf in the same way, over the leaves whose reference gradient is at
  least a thousandth of the median leaf's (the others move under Adam by
  round-off alone);
* ``bn.gap``: the batch-norm running statistics' change over the three
  steps, by the worst leaf in the same way.

The numbers that ``benchmark/limits/<cell>.json`` lists are compared, each
within its limit when it is finite and not above it (:func:`judge`); the
calibration (:mod:`benchmark.calibrate`) prints them all.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import torch

from .lib.flops import FlopCount
from .lib.traffic import make_batch, subseed
from .lib.weights import seeded_state_dict
from .lib.work import PEAK_BYTES, PEAK_F32
from .reference.model import RPEFlow as RefRPEFlow
from .reference.nn.layers import ConvNormAct
from .reference.train import NOC_SUM_KEYS, SUM_KEYS, Adam, metric_sums
from .reference.train import train_step as ref_train_step

MODEL_KEYS = ("images", "pcs", "event_voxel", "intrinsics")
#: the relative size of a flow element's gap that counts it as off
OFF = 1e-3
#: a leaf's reference gradient below this share of the median leaf's moves
#: under Adam by round-off alone, and its change is not compared
STILL = 1e-3


def sum_keys(with_occ: bool):
    return SUM_KEYS + (NOC_SUM_KEYS if with_occ else ())


@contextlib.contextmanager
def tf32(on: bool):
    """Float32 products and convolutions in TF32 (``on``) or full float32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def structure(cell):
    """The reference model of the cell's configuration on the ``meta`` device."""
    with torch.device("meta"):
        return RefRPEFlow(cell.model_ns(), cell.config["n_samples"])


def weights(cell, seed, dev) -> dict:
    """The cell's seeded weights, as a state dict under the upstream names."""
    return seeded_state_dict(structure(cell), subseed(seed, "weights"), dev)


def batch(cell, seed, i, dev) -> dict:
    """Batch ``i`` of the cell's pool."""
    return make_batch(subseed(seed, f"batch{i}"), cell.shape, cell.config["data"], dev)


def reference_model(cell, state_dict, dev, train: bool):
    model = structure(cell).to_empty(device=dev)
    model.load_state_dict(state_dict)
    return model.train(train)


class Counts:
    """What the traced run's readers take from a reference iteration: its
    FLOPs and kernel calls (:class:`FlopCount`), and the least time of the
    convolutions of the conv blocks (every ``ConvNormAct``), each at the
    larger of its FLOPs at the f32 peak and its bytes at the memory peak."""

    def __init__(self, model):
        self.model = model
        self.conv_modules = frozenset(n for n, m in model.named_modules()
                                      if isinstance(m, ConvNormAct))
        self.conv_least_s = 0.0
        self.flops, self.calls = 0.0, []

    def _hook(self, module, args, out):
        w = module.conv_fn.weight
        flops = 2.0 * out.numel() * w[0].numel()
        nbytes = 4.0 * (args[0].numel() + w.numel() + out.numel())
        self.conv_least_s += max(flops / PEAK_F32, nbytes / PEAK_BYTES)

    @contextlib.contextmanager
    def __call__(self):
        handles = [m.register_forward_hook(self._hook) for m in self.model.modules()
                   if isinstance(m, ConvNormAct)]
        try:
            with FlopCount() as count:
                yield self
        finally:
            for h in handles:
                h.remove()
        self.flops, self.calls = count.total, list(count.calls)


# -- eval ---------------------------------------------------------------------


def reference_eval(cell, seed, pool_indices, dev, state_dict=None, count=False,
                   half=False, judged=None):
    """The reference's ``(flows, sums)`` on each of the pool's batches
    ``pool_indices``; with ``count`` also the :class:`Counts` of the first.
    The sums are those of the flows ``judged`` (one dict of ``flow_2d`` and
    ``flow_3d`` per batch: the program's) or, without it, of the reference's
    own. ``half`` runs the forward on the first half of each batch and
    repeats its outputs (the fault of a step that leaves half the batch
    out)."""
    sd = weights(cell, seed, dev) if state_dict is None else state_dict
    model = reference_model(cell, sd, dev, train=False)
    del sd
    counts = Counts(model) if count else None
    out = []
    for k, i in enumerate(pool_indices):
        bt = batch(cell, seed, i, dev)
        with torch.no_grad(), (counts() if counts and k == 0 else contextlib.nullcontext()):
            inputs = {key: bt[key] for key in MODEL_KEYS}
            if half:
                keep = max(1, cell.shape["b"] // 2)
                flows = model({key: t[:keep] for key, t in inputs.items()})
                reps = -(-cell.shape["b"] // keep)
                flows = {key: f.repeat(reps, *[1] * (f.dim() - 1))[:cell.shape["b"]]
                         for key, f in flows.items()}
            else:
                flows = model(inputs)
            sums = metric_sums(flows if judged is None else judged[k], bt, cell.with_occ)
            sums = torch.stack([sums[key] for key in sum_keys(cell.with_occ)]).tolist()
        out.append(({key: flows[key] for key in ("flow_2d", "flow_3d")}, sums))
    return out, counts


def _diff(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``|p - r|`` in float64: 0 where the two are equal (an infinity both
    overflowed to) or both NaN, infinite where one is NaN."""
    p, r = p.double().flatten(), r.double().flatten()
    same = (p == r) | (torch.isnan(p) & torch.isnan(r))
    return torch.where(same, 0.0, torch.nan_to_num((p - r).abs(), nan=math.inf))


def element_gaps(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Each element's ``|p - r| / (|r| + rms(r))`` (0 where they are equal)."""
    r64 = r.double().flatten()
    scale = r64.abs() + torch.sqrt(torch.nanmean(r64 * r64))
    d = _diff(p, r)
    return torch.where(d == 0, 0.0, torch.nan_to_num(d / scale, nan=math.inf))


def off_share(p: torch.Tensor, r: torch.Tensor) -> float:
    """Share of the elements of ``p`` off the reference ``r`` (module doc)."""
    if p.shape != r.shape:
        return 1.0
    return float((element_gaps(p, r) > OFF).double().mean())


def quantile_gaps(p: torch.Tensor, r: torch.Tensor, qs=(0.5, 0.9)) -> list:
    """The ``qs`` quantiles of the elements' gaps (module doc)."""
    if p.shape != r.shape:
        return [math.inf] * len(qs)
    gaps = element_gaps(p, r).cpu()
    return [float(torch.kthvalue(gaps, max(1, math.ceil(q * gaps.numel()))).values) for q in qs]


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """``||p - r|| / ||r||`` (module doc)."""
    if p.shape != r.shape:
        return math.inf
    d = torch.linalg.vector_norm(_diff(p, r))
    gap = 0.0 if d == 0 else float(d / torch.linalg.vector_norm(r.double()))
    return gap if math.isfinite(gap) else math.inf


def sums_gap(p, r, keys) -> float:
    """The largest gap of the sums ``p`` from ``r`` (lists in ``keys``'
    order; module doc)."""
    if len(p) != len(r) or len(r) != len(keys):
        return math.inf
    ref = dict(zip(keys, r))
    gaps = [0.0 if a == b else abs(a - b) / max(abs(b), ref[k.split("/")[0] + "/counts"], 1.0)
            for k, a, b in zip(keys, p, r)]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


EVAL_NUMBERS = ("flow_2d.off", "flow_2d.rel", "flow_2d.q50", "flow_2d.q90", "flow_3d.off",
                "flow_3d.rel", "flow_3d.q50", "flow_3d.q90", "sums.gap")


def eval_numbers(program, reference, keys) -> dict:
    """The eval cell's numbers: the worst over the sampled iterations of
    ``program`` and ``reference``, each a list of ``(flows, sums)``, the
    sums in ``keys``' order."""
    if len(program) != len(reference) or not program:
        return {k: math.inf for k in EVAL_NUMBERS}
    numbers = {}
    for (pf, ps), (rf, rs) in zip(program, reference):
        sample = {"sums.gap": sums_gap(ps, rs, keys)}
        for key in ("flow_2d", "flow_3d"):
            sample[f"{key}.off"] = off_share(pf[key], rf[key])
            sample[f"{key}.rel"] = rel_gap(pf[key], rf[key])
            sample[f"{key}.q50"], sample[f"{key}.q90"] = quantile_gaps(pf[key], rf[key])
        numbers = {k: max(v, numbers.get(k, 0.0)) for k, v in sample.items()}
    return {k: numbers[k] for k in EVAL_NUMBERS}


# -- train --------------------------------------------------------------------


def norms(tensors: dict) -> dict:
    """The norm of each tensor, by name (one transfer to the host)."""
    names = list(tensors)
    if not names:
        return {}
    values = torch.stack(torch._foreach_norm([tensors[n].float() for n in names])).tolist()
    return dict(zip(names, values))


def running_stats(model) -> dict:
    return {n: b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


def state_readings(model, first_grads: dict, losses: list, state_dict: dict) -> dict:
    """What a train cell compares of three steps: the losses, the first
    gradients' norms, the norms of the parameters' and the running
    statistics' change from ``state_dict``, each by name."""
    with torch.no_grad():
        change = norms({n: p - state_dict[n] for n, p in model.named_parameters()})
        bn = norms({n: b - state_dict[n] for n, b in running_stats(model).items()})
    return {"loss": list(losses), "grad": norms(first_grads), "change": change, "bn": bn}


def reference_train(cell, seed, dev, steps=3, count=False, half=False):
    """The reference's readings of the cell's first ``steps`` steps (pool
    batches 0, 1, ...); with ``count`` also the :class:`Counts` of the first
    step. ``half`` trains on the first half of each batch (a fault)."""
    sd = weights(cell, seed, dev)
    model = reference_model(cell, sd, dev, train=True)
    training = cell.config["training"]
    opt = Adam(model, training["lr"]["init_value"], training["weight_decay"],
               training["bias_decay"])
    gen = torch.Generator(device=dev).manual_seed(subseed(seed, "mi"))
    counts = Counts(model) if count else None
    losses, first = [], None
    for i in range(steps):
        bt = batch(cell, seed, i, dev)
        if half:
            keep = max(1, cell.shape["b"] // 2)
            bt = {k: t[:keep] for k, t in bt.items()}
        with counts() if counts and i == 0 else contextlib.nullcontext():
            loss, used = ref_train_step(model, opt, bt, gen)
        losses.append(loss)
        if i == 0:
            first = {n: g.clone() for n, g in used.items()}
    return state_readings(model, first, losses, sd), counts


def _leaf_gap(p: dict, r: dict, names=None) -> float:
    """The worst leaf's ``|p - r| / max(r, median r)`` over ``names`` (all of
    ``r``'s by default); a leaf ``p`` lacks reads as not moved."""
    names = list(r) if names is None else names
    if not names:
        return 0.0
    floor = statistics.median(r[n] for n in names)
    return max(abs(p.get(n, 0.0) - r[n]) / max(r[n], floor) if max(r[n], floor) > 0
               else abs(p.get(n, 0.0)) for n in names)


def train_numbers(program: dict, reference: dict) -> dict:
    """The train cell's numbers from two :func:`state_readings`."""
    lp, lr = program["loss"], reference["loss"]
    loss_gap = (max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr))
                if len(lp) == len(lr) and lr else math.inf)
    grads = reference["grad"]
    median = statistics.median(grads.values()) if grads else 0.0
    moving = [n for n in reference["change"] if grads.get(n, 0.0) >= STILL * median]
    first = (abs(lp[0] - lr[0]) / max(abs(lr[0]), 1e-30) if len(lp) == len(lr) and lr
             else math.inf)
    numbers = {"loss.gap": loss_gap, "loss1.gap": first,
               "grad.gap": _leaf_gap(program["grad"], grads),
               "change.gap": _leaf_gap(program["change"], reference["change"], moving),
               "bn.gap": _leaf_gap(program["bn"], reference["bn"])}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in numbers.items()}


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: every number finite and within its limit;
    ``checks`` each number beside its limit."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": limit}
              for k, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok and bool(checks), checks
