"""The traced run's reading (``benchmark/lib/profile.py : read``) and every
per-layer metric reader, on a synthetic event list whose answers are worked
out by hand here."""

import pytest
from torch.autograd import DeviceType

from benchmark import harness
from benchmark.lib import profile
from benchmark.lib.work import call_bound

US = 1000  # ns


class Ev:
    """A stand-in for a kineto event (the methods :func:`profile.read` calls)."""

    def __init__(self, name, start_us, end_us, corr=0, linked=0, cuda=False, thread=1):
        self._name, self.a, self.b = name, start_us * US, end_us * US
        self.corr, self.linked, self.cuda, self.thread = corr, linked, cuda, thread

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self.cuda else DeviceType.CPU

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def duration_ns(self):
        return self.b - self.a

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_thread_id(self):
        return self.thread


FPS_SHAPE = (8, 16384, 4096)
EVENTS = [
    Ev("run0", 0, 1000, corr=1),
    Ev("module::core.flow.conv1", 100, 400, corr=2),
    Ev("aten::conv2d", 110, 300, corr=5),
    Ev("cudaLaunchKernel", 120, 125, corr=7),
    Ev("implicit_convolve_sgemm", 150, 350, corr=7, linked=5, cuda=True),
    Ev("cudaLaunchKernel", 450, 455, corr=8),
    Ev("void fps_kernel<512>(float const*, int*)", 500, 600, corr=8, linked=0, cuda=True),
    Ev("cudaMemcpyAsync", 690, 695, corr=9),
    Ev("Memcpy DtoH (Device -> Pageable)", 700, 750, corr=9, cuda=True),
    Ev("aten::topk", 740, 900, corr=10),
    Ev("cudaLaunchKernel", 1200, 1205, corr=11),  # after the window: not counted
    Ev("late_kernel", 1300, 1400, corr=11, cuda=True),
]


@pytest.fixture
def trace():
    t = profile.read(EVENTS)
    t.flops_per_iter = 6.7e9
    t.calls = [("fps", FPS_SHAPE), ("gdfn", (1, 8, 8, 32, 85))]
    t.conv_modules = frozenset({"core.flow.conv1"})
    t.conv_least_s = 1e-4
    t.peak_bytes = 3 * 2**30
    return t


def test_read(trace):
    assert trace.iterations == 1 and trace.windows_s == [1e-3]
    assert [(i.kind, i.module, i.hand) for i in trace.items] == [
        ("kernel", "core.flow.conv1", None), ("kernel", "(no module)", "fps"),
        ("memcpy", "(no module)", None)]
    assert trace.items[0].category == "cuDNN conv"
    assert trace.busy_s == pytest.approx(350e-6)
    # idle: 0-150 and 600-700 us under no operator, 350-500 in the conv's
    # module scope after its operator returned, 750-1000 under aten::topk
    assert [(round(s * 1e6), label) for s, label in trace.gaps] == [
        (250, "(no host operator)"), (250, "aten::topk"), (150, "python in core.flow.conv1")]
    assert profile.breakdown(trace)["device_ops"][0] == ["cuDNN conv @ core.flow.conv1",
                                                         pytest.approx(200e-6)]


def read(metric, t):
    return harness.load_cell("ft3d_eval" if "eval" in metric else "ft3d_train") \
        .reader(metric).read(t)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_readers(trace, mode):
    assert read(f"mfu.{mode}", trace) == pytest.approx(10.0)
    assert read(f"kernel_launches.{mode}", trace) == 2
    assert read(f"device_idle_share.{mode}", trace) == pytest.approx(65.0)
    # gdfn ran no kernel: its call is left out
    assert read(f"hand_kernels_roofline.{mode}", trace) == pytest.approx(
        100 * call_bound("fps", FPS_SHAPE) / 0.1)


def test_conv_and_memory_readers(trace):
    assert read("conv_roofline.eval", trace) == pytest.approx(50.0)
    assert read("peak_gib.train", trace) == pytest.approx(3.0)


def test_readers_find_nothing_to_read():
    empty = profile.read([Ev("run0", 0, 1000, corr=1)])
    for metric in [m["name"] for m in harness.load_spec()["per_layer"]]:
        assert read(metric, empty) is None, metric
