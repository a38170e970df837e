"""The port's profiler spans (``rpeflow_tpu_torch/utils/profile.py : span``).

A tiny model (64x64 frames, 64 points, decode levels 2 and 1) runs one
``train_step`` and one eval forward with ``_metric_sums`` under a CPU
``torch.profiler`` with the spans on (``record_spans``): every span of the
train step, the forward, the decoder and the metric sums appears once a
call, inside its parent, the forward's stages in code order, and all on the
calling thread (the backward's recompute of the activation checkpoints
opens none). With no profiler recording, or a profiler but the spans off,
a span enters no ``record_function``. On a synthetic card trace,
``span_table`` and ``analyse`` give their hand-worked values.
"""

import pytest
import torch

from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
from rpeflow_tpu_torch.train.config import ConfigNode
from rpeflow_tpu_torch.train.evaluator import _metric_sums
from rpeflow_tpu_torch.train.optim import optimizer_factory
from rpeflow_tpu_torch.train.state import train_step
from rpeflow_tpu_torch.utils.profile import SPAN, analyse, record_spans, span_table
from torch_port_utils import make_inputs, small_cfg_dict

N_SAMPLES = (32, 16)
LOSS = {"level_weights": [8, 4, 2, 1, 0.5], "order": "l2"}
TRAINING = {"max_epochs": 10, "optimizer": "adam",
            "lr": {"scheduler": "MultiStepLR", "init_value": 1e-4, "decay_rate": 0.5,
                   "decay_milestones": [5]},
            "weight_decay": 1e-6, "bias_decay": 0.0}

FORWARD = {"rpeflow.forward.pyramid3d": "rpeflow.forward",
           "rpeflow.forward.encode": "rpeflow.forward",
           "rpeflow.forward.encode_event": "rpeflow.forward",
           "rpeflow.forward.decode": "rpeflow.forward",
           "rpeflow.forward.decode.level2": "rpeflow.forward.decode",
           "rpeflow.forward.decode.level1": "rpeflow.forward.decode",
           "rpeflow.forward.decode.post": "rpeflow.forward.decode",
           "rpeflow.forward.outputs": "rpeflow.forward"}
#: every span of one call, with its parent span (None: outermost)
PARENTS = {
    "train": {"rpeflow.train_step": None, "rpeflow.forward": "rpeflow.train_step", **FORWARD,
              "rpeflow.forward.loss": "rpeflow.forward",
              "rpeflow.train_step.backward": "rpeflow.train_step",
              "rpeflow.train_step.update": "rpeflow.train_step",
              "rpeflow.train_step.read": "rpeflow.train_step"},
    "eval": {"rpeflow.forward": None, **FORWARD, "rpeflow.eval.metric_sums": None},
}
#: the forward's stages in code order
STAGES = {"train": ["pyramid3d", "encode", "encode_event", "decode", "outputs", "loss"],
          "eval": ["pyramid3d", "encode", "encode_event", "decode", "outputs"]}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    batch = make_inputs(0, targets=True)
    batch["flow_3d"] = torch.cat([torch.from_numpy(batch["flow_3d"]),
                                  1.0 - torch.from_numpy(batch["occ_mask_3d"])[..., None]], -1)
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _call(mode):
    """One call of ``mode`` on a fresh tiny model: a train step, or an eval
    forward and its metric sums."""
    model = seeded_init_(RPEFlow(ConfigNode(dict(small_cfg_dict(), loss2d=LOSS, loss3d=LOSS)),
                                 N_SAMPLES), seed=0)
    batch = _batch()
    if mode == "train":
        model.train()
        opt = optimizer_factory(ConfigNode(TRAINING), model, steps_per_epoch=10)
        return lambda: train_step(model, opt, batch, torch.Generator().manual_seed(3))

    def run():
        with torch.inference_mode():
            _metric_sums(model({k: batch[k] for k in ("images", "pcs", "event_voxel",
                                                      "intrinsics")}), batch, True)
    return run


def _spans(mode):
    """The ``rpeflow.`` spans of one profiled call: (name, start, end, thread)
    in start order."""
    run = _call(mode)
    record_spans(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run()
    finally:
        record_spans(False)
    events = prof.profiler.kineto_results.events()
    return sorted(((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()) for e in events
                   if e.name().startswith(SPAN)), key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """Each span's innermost enclosing span on its thread."""
    out, stack = [], []
    for name, start, end, thread in spans:
        while stack and not (stack[-1][3] == thread and start >= stack[-1][1]
                             and end <= stack[-1][2]):
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, start, end, thread))
    return out


@pytest.fixture(scope="module", params=["train", "eval"])
def traced(request):
    return request.param, _spans(request.param)


def test_every_span_once_inside_its_parent(traced):
    mode, spans = traced
    parents = _parents(spans)
    assert len(parents) == len(PARENTS[mode]), [n for n, _ in parents]
    assert dict(parents) == PARENTS[mode]


def test_forward_stages_and_decode_levels_in_code_order(traced):
    mode, spans = traced
    names = [n for n, *_ in spans]
    stages = [n[len("rpeflow.forward."):] for n in names
              if n.startswith("rpeflow.forward.") and n.count(".") == 2]
    assert stages == STAGES[mode]
    levels = [n for n in names if n.startswith("rpeflow.forward.decode.level")]
    assert levels == [f"rpeflow.forward.decode.level{k}" for k in range(len(N_SAMPLES), 0, -1)]
    assert names.index("rpeflow.forward.decode.post") > names.index(levels[-1])


def test_no_span_on_the_autograd_thread(traced):
    """All spans on the calling thread, and none of the forward inside the
    backward, where the activation checkpoints re-run their blocks."""
    mode, spans = traced
    assert len({thread for *_, thread in spans}) == 1
    if mode == "train":
        (_, a, b, _), = [s for s in spans if s[0] == "rpeflow.train_step.backward"]
        assert not [n for n, start, *_ in spans if n.startswith("rpeflow.forward")
                    and a <= start <= b]


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_span_enters_no_record_function_without_a_profiler(monkeypatch, mode):
    """No ``record_function`` without a profiler (spans on or off), nor
    under a profiler with the spans off; every span under both."""
    entered = []
    record_function = torch.autograd.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return record_function(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    run = _call(mode)
    run()
    record_spans(True)
    try:
        run()
    finally:
        record_spans(False)
    assert [n for n in entered if n.startswith(SPAN)] == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run()
    assert [n for n in entered if n.startswith(SPAN)] == []
    record_spans(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            run()
    finally:
        record_spans(False)
    assert sorted(n for n in entered if n.startswith(SPAN)) == sorted(PARENTS[mode])


class Ev:
    """A kineto event's values, in us, as ``utils/profile.py`` reads them."""

    def __init__(self, name, a, b, corr, linked=0, thread=1, cuda=False, annotation=False):
        self.values = name, a, b, corr, linked, thread, cuda, annotation

    def name(self):
        return self.values[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self.values[6] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self.values[7]

    def start_ns(self):
        return self.values[1] * 1000

    def end_ns(self):
        return self.values[2] * 1000

    def duration_ns(self):
        return (self.values[2] - self.values[1]) * 1000

    def correlation_id(self):
        return self.values[3]

    def linked_correlation_id(self):
        return self.values[4]

    def start_thread_id(self):
        return self.values[5]


# one traced train step on a synthetic card: a conv launched inside decode
# level 1, an elementwise kernel launched by the autograd thread during the
# backward, a copy in the update; and a span's device copy, which is no work
CARD = [
    Ev("run0", 0, 1000, 1),
    Ev("rpeflow.train_step", 10, 990, 2),
    Ev("rpeflow.forward", 20, 400, 3),
    Ev("rpeflow.forward.decode", 100, 380, 4),
    Ev("rpeflow.forward.decode.level1", 110, 300, 5),
    Ev("module::core.conv1", 120, 200, 6),
    Ev("aten::convolution", 125, 195, 10),
    Ev("cudaLaunchKernel", 130, 135, 100),
    Ev("implicit_convolve_sgemm", 150, 350, 100, linked=10, cuda=True),
    Ev("rpeflow.train_step.backward", 410, 700, 7),
    Ev("aten::mul", 450, 460, 11, thread=2),
    Ev("cudaLaunchKernel", 452, 453, 101, thread=2),
    Ev("vectorized_elementwise_kernel", 500, 600, 101, linked=11, cuda=True),
    Ev("rpeflow.train_step.update", 710, 900, 8),
    Ev("aten::copy_", 720, 730, 12),
    Ev("cudaMemcpyAsync", 722, 723, 102),
    Ev("Memcpy HtoD (Pageable -> Device)", 740, 760, 102, linked=12, cuda=True),
    Ev("rpeflow.forward", 150, 350, 3, cuda=True, annotation=True),
]


def test_span_table_of_a_synthetic_card_trace():
    table = span_table(CARD)
    assert (table["runs"], table["top_module"]) == (1, "core.conv1")
    rows = {name: (r["count"], r["wall_ms"], r["busy_ms"], r["launched_ms"], r["top_ms"])
            for name, r in table["spans"].items()}
    assert list(rows) == ["rpeflow.train_step", "rpeflow.forward", "rpeflow.forward.decode",
                          "rpeflow.forward.decode.level1", "rpeflow.train_step.backward",
                          "rpeflow.train_step.update"]
    assert rows == {
        "rpeflow.train_step": pytest.approx((1, 0.98, 0.32, 0.32, 0.2)),
        "rpeflow.forward": pytest.approx((1, 0.38, 0.2, 0.2, 0.2)),
        "rpeflow.forward.decode": pytest.approx((1, 0.28, 0.2, 0.2, 0.2)),
        # the conv runs past the level's end: launched inside, busy in part
        "rpeflow.forward.decode.level1": pytest.approx((1, 0.19, 0.15, 0.2, 0.2)),
        # launched by the autograd thread while the main thread waits in it
        "rpeflow.train_step.backward": pytest.approx((1, 0.29, 0.1, 0.1, 0.0)),
        "rpeflow.train_step.update": pytest.approx((1, 0.19, 0.02, 0.02, 0.0)),
    }
    assert table["spans"]["rpeflow.train_step.backward"]["idle_pct"] == pytest.approx(
        100 * 190 / 290)
    assert (table["idle_ms"], table["idle_outside_spans_ms"]) == pytest.approx((0.68, 0.02))
    assert (table["least_lag_us"], table["lags_below_0"]) == (20, 0)


def test_analyse_of_a_synthetic_card_trace():
    windows, per_run, busy, by_kernel = analyse(CARD, on_card=True)
    assert windows == [(0, 1000)] and busy == [320]
    assert dict(per_run[0]) == pytest.approx({"cuDNN conv": 0.2, "elementwise": 0.1,
                                              "memcpy/memset": 0.02})
    assert dict(by_kernel) == pytest.approx({
        ("implicit_convolve_sgemm", "core.conv1", "cuDNN conv"): 200,
        ("vectorized_elementwise_kernel", "(no module)", "elementwise"): 100,
        ("Memcpy HtoD (Pageable -> Device)", "(no module)", "memcpy/memset"): 20})
