#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rpeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. device: the card's name and power limit; CUDA must be available;
  2. build: the Hopper kernels from rpeflow_tpu_torch/csrc (nvcc, one process
     per source);
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at every shape the flagship forward and training step give it,
     with timings, each shape's bound (bytes at 3.35 TB/s, operations at
     67 TFLOP/s f32 or 495 TFLOP/s TF32) and, for the depthwise conv
     (forward and fused backward) and the decoder's 3x3 conv (F.conv2d),
     one library call's time; the correlation's forward and, apart, its
     fused backward; then edge shapes (ragged GDFN, MDTA, depthwise-conv,
     correlation and decoder-conv tiles, FPS ties, MDTA, depthwise-conv,
     correlation-backward and decoder-conv determinism), checked;
  4. card vs CPU: the whole eval forward at a reduced shape, same weights;
  5. flagship: the FlyingThings3D eval forward (batch 4, 576x960, 20-channel
     event voxel, 8192 + 8192 points, 5 decode levels), launch counts of
     every kernel, output shapes, metric sums (its timing: phase 12);
  6. autograd on the card: the gradients of the correlation, MDTA, GDFN and
     depthwise-conv functions (kernels inside) against torch.autograd
     through their plain compositions, at level-1 shapes;
  7. train step, card vs CPU, at the reduced shape of phase 4, MI off, the
     CPU replaying the card's index and activation-sign choices: loss,
     per-leaf gradients and updated batch statistics;
  8. flagship training: conf/train/pretrain.yaml's model at the FT3D
     training shape (batch 4, 540x960 frames, 8192 + 8192 points), MI on,
     one warm-up and five timed steps (the first captures the step as a
     CUDA graph, the others replay it), launches of every kernel in one step
     (five of the correlation's backward), then a checkpoint loaded strictly
     into the eval model;
  9. data parallelism (rpeflow_tpu_torch.parallel) on the card: (a) the
     reduced step of phase 7 at batch 2, MI on, inside a one-rank NCCL group
     against the same step with no group, under phase 7's bounds, with the
     collectives of one step by call site; (b) two gloo ranks spawned on
     this card, one sample each, against the same one-process step at batch
     2, their parameters bitwise equal; (c) phase 8's training through a
     one-rank NCCL group: launches, ms/step and peak memory beside phase 8's;
 10. amp (bfloat16 in the two 2-D feature pyramids only): the pyramids and
     the forward at phase 4's shape against the CPU's amp model, forward
     hooks on every module, and phase 8's training with amp: ms/step and
     peak memory;
 11. the tools (scripts/torch_*.py): (a) the gather tool at B = 4, N = 8192,
     K = 16, C = 128 (every variant held exactly to the plain version, then
     timed), both gathers exactly equal to their plain versions at edge
     shapes; (b) the zero store against its plain version, and the repro
     graph FINITE with the store's output discarded and added; the three
     tool kernels' and their library calls' device ms (torch.profiler) and
     host us a call from scripts/torch_tools_probe.py in a fresh process;
     (c) the native event voxelizers against the numpy ones at DSEC scale
     (480x640, 15 bins, 500k events; atol 1e-6), with both times; (d) the
     profile of the flagship forward (categories, busy share); (e) two steps
     of the train-step tool; each in a process of its own, (f) the KNN-1
     bench at B = 4, Q = 34560, N = 4096 (the four formulations' indices
     equal to the port's ``k_nearest_neighbor``'s on inputs whose squared
     distances are exact, their ms and peak memory), (g) the convex-upsample
     bench at [4, 144, 240], S = 4 (variants B and C within 1e-4 of the
     port's ``convex_upsample``, their ms), (h) the eval-resample study at
     its defaults (batch 2, 288x480, 8192 points, three draws; every metric
     finite, each of the five model kernels launched);
 12. the bench (``python -m rpeflow_tpu_torch.bench --workload all``) twice,
     each in a fresh process: its ``layers`` line and a metric line for each
     workload parse, each ``value`` finite, each ``mfu`` in (0, 1.05]; both
     runs' medians side by side;
 13. DSEC (conf/test/dsec.yaml, conf/train/dsec.yaml; ``flagship.DSEC_EVAL``,
     ``DSEC_TRAIN``, batches of DSEC's form from ``make_dsec_batch``): (a) the
     eval forward at batch 3, 480x640, 8192 + 8192 points, its launches
     (those of ``bench.EVAL_LAUNCHES``), shapes and ``with_occ=False`` metric
     sums, 1 warm-up and 3 timed forwards, peak memory; (b) the fine-tune
     step (l1, MI on, Adam) at the same shape, its launches
     (``bench.TRAIN_LAUNCHES``), 1 warm-up and 3 timed steps, peak memory,
     then the same at conf/train/dsec.yaml's global batch of 12 on one card;
     (c) each model kernel against its plain version, under phase 3's
     tolerances and timed, at every distinct shape that (a) and (b) gave it
     (their warm-ups recorded at the wrappers, ``utils/flops.py :
     FlopCount.calls``); (d) card against CPU at DSEC's 3:4 aspect, batch 1,
     144x192, 2048 points: the forward and its metric sums, and one l1 step
     with the sparse masks under phase 7's bounds. One JSON line
     ``{"dsec": ...}`` holds its numbers;
 14. the train step as a CUDA graph (``train/graph.py``) at phase 8's FT3D
     and phase 13(b)'s DSEC shapes, MI on: 4 steps from the same weights,
     batches and MI seed, three times eagerly (``eager_train_step``) and
     once through ``train_step`` (first sight, capture and a replay, a
     replay): ms a step, the step counter, the launches of each step equal
     to an eager step's, and per group (parameters, Adam's state, buffers,
     summaries) the relative norm of the graphed run's difference to its
     nearest eager run, held to twice the largest between two eager runs,
     and the leaf of the largest gap. One JSON line ``{"step_graph": ...}``.
The second-to-last line is a JSON object of per-kernel results (phase 3's
times, errors, bounds and library time summed over the shapes; the launches
of one eval forward, phase 5, or, for the correlation's backward, which the
eval forward does not run, of one train step, phase 8; and the launches of
one train step; for the tools' kernels, phase 11's times at the tool's
shape, with the device ms and host us of the wrapper and the library call,
and the launches of one call of the tool named in ``path``), the last
``{"ok": true, "device": {...}}``. Weights and inputs are random, from seeds.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rpeflow_tpu_torch.flagship import (  # noqa: F401 (read by the probes under scripts/)
    FLAGSHIP,
    N_SAMPLES,
    TRAIN,
    make_batch,
    model_cfg,
    training_cfg,
)
from rpeflow_tpu_torch.utils import timing
from rpeflow_tpu_torch.utils.work import bound, kernel_work

SEED = 0
REDUCED = dict(b=1, h=128, w=192, n=2048, event_ch=20)
REDUCED_SAMPLES = (1024, 512, 256, 128, 64)
# per decode level l = 1..5 at the flagship shape (576x960 -> 144x240 at l = 1)
LEVELS = [(144 >> i, 240 >> i, [32, 64, 96, 128, 192][i], 4096 >> i) for i in range(5)]
SOURCES = {
    "fps": ("rpeflow_tpu_torch/csrc/fps.cu", "rpeflow_tpu/ops/pallas/fps.py:53"),
    "correlation2d": ("rpeflow_tpu_torch/csrc/correlation.cu",
                      "rpeflow_tpu/ops/pallas/correlation.py:78"),
    "correlation2d_bwd": ("rpeflow_tpu_torch/csrc/correlation.cu",
                          "rpeflow_tpu/ops/correlation.py:52"),
    "mdta_qkv": ("rpeflow_tpu_torch/csrc/mdta.cu", "rpeflow_tpu/ops/pallas/mdta.py:170"),
    "gdfn": ("rpeflow_tpu_torch/csrc/gdfn.cu", "rpeflow_tpu/ops/pallas/gdfn.py:135"),
    "dwconv": ("rpeflow_tpu_torch/csrc/dwconv.cu", "rpeflow_tpu/ops/pallas/dwconv.py:90"),
    "conv3x3": ("rpeflow_tpu_torch/csrc/conv3x3.cu",
                "none: XLA's conv (rpeflow_tpu/nn/layers.py:98)"),
}
# the kernels of the tools (phase 11): source, the Pallas kernel replaced,
# the tool whose call launches them
TOOL_SOURCES = {
    "gather_rows": ("rpeflow_tpu_torch/csrc/gather.cu",
                    "scripts/bench_gather.py:83 (pallas_rows; pallas_rowloop :111)",
                    "scripts/torch_bench_gather.py"),
    "gather_lanes": ("rpeflow_tpu_torch/csrc/gather.cu", "scripts/bench_gather.py:145",
                     "scripts/torch_bench_gather.py"),
    "zero_store": ("rpeflow_tpu_torch/csrc/zero_store.cu", "triage/repro_xla_custom_call.py:44",
                   "scripts/torch_repro_custom_call.py"),
}
# kernels each path must launch (the eval forward's point-map GDFN runs the
# depthwise kernel too; only training runs the correlation's backward)
EXPECTED = {"eval forward": set(SOURCES) - {"correlation2d_bwd"}, "train step": set(SOURCES),
            "gather tool": {"gather_rows", "gather_lanes"}, "repro tool": {"zero_store"}}


def time_ms(fn, runs=20, warmup=3):
    """Median ms of ``fn()`` over ``runs`` calls, CUDA events around each."""
    return timing.time_ms(fn, torch.device("cuda", torch.cuda.current_device()), runs, warmup)


def errors(out, ref):
    d = (out.double() - ref.double()).abs()
    scale = ref.double().abs().max().clamp_min(1e-30)
    return float(d.max()), float(d.max() / scale)


def check_close(name, out, ref, atol, rtol):
    ok = torch.allclose(out, ref, atol=atol, rtol=rtol)
    if not ok:
        raise AssertionError(f"{name}: max |d| {errors(out, ref)[0]:.3e} beyond "
                             f"atol {atol} rtol {rtol}")


def max_rel(out, ref):
    """Largest difference relative to the largest entry of ``ref``."""
    return errors(out, ref)[1]


# (B, H, W, C, kh) the depthwise conv is checked at beyond the training
# step's: tiles, strips and channel blocks cut by the edge at C = 3 to 1020,
# W below one tile, W = 1, H = 1 with kh = 3, one pixel, point runs of N not
# a multiple of the tile, and a batch of more blocks than the card holds
DWCONV_EDGE_SHAPES = [(4, 131, 77, c, 3) for c in (3, 32, 81, 170, 510, 1020)] + [
    (2, 9, 5, 32, 3), (2, 7, 1, 81, 3), (3, 1, 40, 170, 3), (1, 1, 1, 3, 3),
    (3, 1, 777, 170, 1), (2, 1, 1001, 32, 1), (1, 1, 1, 81, 1), (600, 4, 40, 64, 3)]


# (B, H, W, C, d) the correlation is checked at beyond the flagship's: tiles
# cut by the edge, C not a multiple of 4 (3, 81) or of the 32-channel chunk
# (20), d = 0, 1 and 4, B = 1, one pixel, and maps of one or two tile rows
CORR_EDGE_SHAPES = [(b, h, w, c, d) for b, h, w, c in ((1, 37, 61, 20), (2, 5, 7, 3),
                                                       (1, 9, 15, 81))
                    for d in (0, 1, 4)]
CORR_EDGE_SHAPES += [(1, 144, 240, 32, 1), (4, 72, 120, 64, 0), (1, 1, 1, 32, 4),
                     (3, 2, 33, 96, 4)]
#: the non-default plan each edge shape is also run under: 3-row, 32-column
#: tiles (rows and columns cut by the edge)
CORR_EDGE_PLAN = dict(th=3, tw=32)

# (B, H, W, Cin, Cout, d) the decoder conv is checked at beyond the model's,
# each under every tile: Cin not a multiple of 4 or of the 16-channel chunk
# (3, 17, 98, 243), Cout not a multiple of the tile (4, 36, 68), one pixel,
# fewer pixels than a tile, a dilation wider than the map, odd H and W
CONV3X3_EDGE_SHAPES = [(1, 7, 9, 243, 192, 1), (2, 5, 3, 98, 128, 2), (1, 1, 1, 17, 36, 1),
                       (3, 13, 11, 3, 4, 16), (1, 9, 15, 64, 96, 8), (2, 33, 17, 20, 68, 1)]


#: (Cin, Cout, dilation) of the 11 decoder 3x3 convs of a decode level, in
#: call order: FlowEstimator2D's conv1-conv5, ContextNetwork2D's convs.0-5
DECODER_CONVS = [(243, 192, 1), (192, 128, 1), (128, 96, 1), (96, 64, 1), (64, 32, 1),
                 (98, 128, 1), (128, 128, 2), (128, 128, 4), (128, 96, 8), (96, 64, 16),
                 (64, 32, 1)]


def conv3x3_shapes(b, h, w, levels=5):
    """(B, H, W, Cin, Cout, d) of the decoder's 3x3 convs in one forward of a
    batch of ``b`` frames of ``h`` x ``w`` inside the model (after its
    resize to a multiple of 64), in call order: the coarsest level first,
    level l (1 the finest) at ``h / 2^(l + 1)`` x ``w / 2^(l + 1)``."""
    return [(b, h >> (l + 1), w >> (l + 1), *conv) for l in range(levels, 0, -1)
            for conv in DECODER_CONVS]


def dwconv_shapes():
    """(B, H, W, C, kh) of the depthwise conv's calls in one training step
    (one frame, batch 4): per decode level the q/k/v convs of the 2-D MDTA
    blocks (C = c_l, 81, 96), the GDFN hidden maps (2h = 2 int(2.66 C)), and
    the point maps' convs (kh = 1)."""
    shapes = []
    for h, w, c, n in LEVELS:
        for cc in dict.fromkeys((c, 81, 96)):
            shapes += [(4, h, w, cc, 3), (4, h, w, 2 * int(2.66 * cc), 3)]
        shapes += [(4, 1, n, c, 1), (4, 1, n, 2 * int(2.66 * c), 1)]
    return shapes


class KernelCases:
    """Each model kernel against its plain version on the card at one shape,
    inputs drawn from one seeded generator, under phase 3's tolerances; each
    case raises on a breach and returns its inputs, outputs and references."""

    def __init__(self, dev, seed):
        self.dev = dev
        self.g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(self, *shape):
        return torch.randn(*shape, generator=self.g, device=self.dev)

    def fps(self, b, n, s, ties=False):
        """Indices equal to the plain version's."""
        from rpeflow_tpu_torch.ops import fps

        scale = torch.tensor([20., 12., 33.], device=self.dev)
        xyz = torch.rand(b, n, 3, generator=self.g, device=self.dev) * scale
        if ties:  # duplicated points on an integer grid: exact distance ties
            dup = torch.randint(0, max(n // 4, 1), (n,), generator=self.g, device=self.dev)
            xyz = torch.round(xyz[:, dup])
        out = fps.furthest_point_sampling(xyz, s)
        ref = fps.furthest_point_sampling_plain(xyz, s)
        torch.cuda.synchronize()
        n_diff = int((out != ref).sum())
        if n_diff:
            raise AssertionError(f"fps {(b, n, s)} ties={ties}: {n_diff} indices differ")
        return xyz

    def gdfn(self, b, h, w, c):
        """atol 1e-5, rtol 1e-4."""
        from rpeflow_tpu_torch.ops import gdfn

        rnd, hid = self.rnd, int(c * 2.66)
        args = (rnd(b, h, w, c), rnd(c, 2 * hid) / c ** 0.5, rnd(3, 3, 2 * hid) / 3.0,
                rnd(hid, c) / hid ** 0.5)
        out, ref = gdfn.gdfn(*args), gdfn.gdfn_plain(*args)
        check_close(f"gdfn {(b, h, w, c)}", out, ref, atol=1e-5, rtol=1e-4)
        return args, out, ref

    def mdta(self, b, h, w, c, kh):
        """The kernel vs the plain version (v atol 1e-5; qk and sq, sums over
        up to 34,560 tokens in another order, within 1e-4 of their largest
        entry), a second call bitwise equal, the plan's shared memory the
        kernel's own count."""
        from rpeflow_tpu_torch.ops import _cuda, mdta

        rnd = self.rnd
        x, y = rnd(b, h, w, c), rnd(b, h, w, c)
        ln = torch.stack([1 + 0.1 * rnd(c), 0.1 * rnd(c), 1 + 0.1 * rnd(c), 0.1 * rnd(c)])
        args = (x, y, ln, 0.2 * rnd(kh, 3, 3 * c), kh)
        plan = mdta.mdta_plan(b, h, w, c, kh, _cuda.sm_count(self.dev))
        if _cuda.lib().rpeflow_mdta_smem_bytes(c, kh, plan.th, plan.tw) != plan.smem_bytes:
            raise AssertionError(f"mdta_qkv {(b, h, w, c, kh)}: plan and kernel count "
                                 "shared memory differently")
        outs, refs = mdta.mdta_qkv(*args), mdta.mdta_qkv_plain(*args)
        check_close(f"mdta_qkv v {(b, h, w, c, kh)}", outs[0], refs[0], atol=1e-5, rtol=0.0)
        for nm, o, r in zip(("qk", "sq"), outs[1:], refs[1:]):
            if max_rel(o, r) > 1e-4:
                raise AssertionError(f"mdta_qkv {nm} {(b, h, w, c, kh)}: rel err "
                                     f"{max_rel(o, r):.3e} > 1e-4")
        if not all(torch.equal(o, a) for o, a in zip(outs, mdta.mdta_qkv(*args))):
            raise AssertionError(f"mdta_qkv {(b, h, w, c, kh)}: two calls differ")
        return args, outs, refs

    def corr(self, b, h, w, c, d, plans=None):
        """The forward and the fused backward (under ``plans``, else the
        default plans) vs the plain versions (forward atol 1e-5, each
        gradient within 1e-5 of its largest entry), one launch a wrapper
        call, two backward calls bitwise equal."""
        from rpeflow_tpu_torch.ops import _cuda, correlation

        rnd = self.rnd
        f1, f2, g_ = rnd(b, h, w, c), rnd(b, h, w, c), rnd(b, h, w, (2 * d + 1) ** 2)
        if plans is None:
            fwd = lambda: correlation.correlation2d_fwd(f1, f2, d)  # noqa: E731
            bwd = lambda: correlation.correlation2d_bwd(f1, f2, g_, d)  # noqa: E731
        else:
            fwd = lambda: correlation.launch_fwd(f1, f2, plans[0])  # noqa: E731
            bwd = lambda: correlation.launch_bwd(f1, f2, g_, plans[1])  # noqa: E731
        before = dict(_cuda.LAUNCHES)
        out, grads = fwd(), bwd()
        counts = [_cuda.LAUNCHES[k] - before[k] for k in ("correlation2d", "correlation2d_bwd")]
        if counts != [1, 1]:
            raise AssertionError(f"correlation2d {(b, h, w, c, d)}: launches {counts}")
        ref, refs = (correlation.correlation2d_plain(f1, f2, d),
                     correlation.correlation2d_bwd_plain(f1, f2, g_, d))
        check_close(f"correlation2d {(b, h, w, c, d)}", out, ref, atol=1e-5, rtol=0.0)
        for name, got, want in zip(("grad1", "grad2"), grads, refs):
            if max_rel(got, want) > 1e-5:
                raise AssertionError(f"correlation2d {name} {(b, h, w, c, d)}: rel err "
                                     f"{max_rel(got, want):.3e} > 1e-5")
        if not all(torch.equal(a, o) for a, o in zip(grads, bwd())):
            raise AssertionError(f"correlation2d {(b, h, w, c, d)}: two backward calls differ")
        return f1, f2, g_, (out, ref), (grads, refs)

    def dwconv(self, b, h, w, c, kh, plans=None):
        """The forward and the fused backward (under ``plans``, else the
        default plans) vs the plain versions (forward and input gradient
        atol 1e-5, the taps gradient -- a sum over every pixel, in another
        order -- within 1e-4 of its largest entry), one launch a wrapper
        call, two backward calls bitwise equal."""
        from rpeflow_tpu_torch.ops import _cuda, dwconv

        x, gout = self.rnd(b, h, w, c), self.rnd(b, h, w, c)
        taps = self.rnd(kh, 3, c) / 3
        if plans is None:
            fwd = lambda: dwconv.dwconv_fwd(x, taps)  # noqa: E731
            bwd = lambda: dwconv.dwconv_bwd(x, gout, taps)  # noqa: E731
        else:
            fwd = lambda: dwconv.launch_fwd(x, taps, plans[0])  # noqa: E731
            bwd = lambda: dwconv.launch_bwd(x, gout, taps, plans[1])  # noqa: E731
        before = _cuda.LAUNCHES["dwconv"]
        got = (fwd(), *bwd())
        if _cuda.LAUNCHES["dwconv"] - before != 2:
            raise AssertionError(f"dwconv {(b, h, w, c, kh)}: "
                                 f"{_cuda.LAUNCHES['dwconv'] - before} launches for 2 calls")
        want = (dwconv.dwconv_plain(x, taps), *dwconv.dwconv_bwd_plain(x, gout, taps))
        check_close(f"dwconv forward {(b, h, w, c, kh)}", got[0], want[0], atol=1e-5, rtol=0.0)
        check_close(f"dwconv input gradient {(b, h, w, c, kh)}", got[1], want[1], atol=1e-5,
                    rtol=0.0)
        if max_rel(got[2], want[2]) > 1e-4:
            raise AssertionError(f"dwconv taps gradient {(b, h, w, c, kh)}: rel err "
                                 f"{max_rel(got[2], want[2]):.3e}")
        if not all(torch.equal(a, o) for a, o in zip(got[1:], bwd())):
            raise AssertionError(f"dwconv {(b, h, w, c, kh)}: two backward calls differ")
        return x, gout, taps, got, want

    def conv3x3(self, b, h, w, cin, cout, d, plan=None):
        """The forward (under ``plan``, else the default plan) vs its plain
        version, ``F.conv2d`` in float32 with TF32 off (within 1e-4 of its
        largest entry: 9 Cin products summed in another order, against
        cuDNN's pick, an FFT at the widest shapes), one launch a call, two
        calls bitwise equal."""
        from rpeflow_tpu_torch.ops import _cuda, conv3x3

        x = self.rnd(b, h, w, cin)
        weight = self.rnd(cout, cin, 3, 3) / (9 * cin) ** 0.5
        bias = 0.1 * self.rnd(cout)
        if plan is None:
            fwd = lambda: conv3x3.conv3x3_fwd(x, weight, bias, d)  # noqa: E731
        else:
            fwd = lambda: conv3x3.launch(x, weight, bias, plan)  # noqa: E731
        before = _cuda.LAUNCHES["conv3x3"]
        out = fwd()
        if _cuda.LAUNCHES["conv3x3"] - before != 1:
            raise AssertionError(f"conv3x3 {(b, h, w, cin, cout, d)}: "
                                 f"{_cuda.LAUNCHES['conv3x3'] - before} launches for 1 call")
        ref = conv3x3.conv3x3_plain(x, weight, bias, d)
        if max_rel(out, ref) > 1e-4:
            raise AssertionError(f"conv3x3 {(b, h, w, cin, cout, d)}: rel err "
                                 f"{max_rel(out, ref):.3e} > 1e-4")
        if not torch.equal(out, fwd()):
            raise AssertionError(f"conv3x3 {(b, h, w, cin, cout, d)}: two calls differ")
        return x, weight, bias, out, ref


class KernelRecords(dict):
    """Per-kernel sums over the shapes timed: ms, plain ms, the largest
    error, the bound (by what it is bound) and the library call's ms."""

    def record(self, name, shape, out_ms, plain_ms, abs_err, rel_err, library_ms=None):
        r = self.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
                                   "bound_ms": 0.0, "bound": {"bytes": 0.0, "operations": 0.0},
                                   "library_ms": None, "shapes": 0})
        b_ms, by = bound(*kernel_work(name, shape))
        r["shapes"] += 1
        r["ms"] += out_ms
        r["plain_ms"] += plain_ms
        r["max_abs_err"] = max(r["max_abs_err"], abs_err)
        r["bound_ms"] += b_ms
        r["bound"][by] += b_ms
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms
        lib = "" if library_ms is None else f"  library {library_ms:9.4f} ms"
        print(f"  {name:14s} {str(shape):28s} kernel {out_ms:9.4f} ms  plain {plain_ms:9.4f} ms"
              f"{lib}  bound {b_ms:8.4f} ms ({by})  max|d| {abs_err:.3e}  rel {rel_err:.3e}",
              flush=True)


def dwconv_timed(results, cases, shape, runs=20, warmup=3):
    """The depthwise conv's case at ``shape``, timed: the kernel's forward +
    fused backward against the plain conv's forward + autograd backward, and
    against one library call, F.conv2d(groups=C) on the channels-last view,
    forward + backward."""
    import torch.nn.functional as F

    from rpeflow_tpu_torch.ops import dwconv

    x, gout, taps, got, want = cases.dwconv(*shape)
    kh, c = taps.shape[0], x.shape[-1]

    def kernel_pass():
        return dwconv.dwconv_fwd(x, taps), *dwconv.dwconv_bwd(x, gout, taps)

    xl, tl = x.clone().requires_grad_(), taps.clone().requires_grad_()

    def plain_pass():
        out = dwconv.dwconv_plain(xl, tl)
        return (out.detach(), *torch.autograd.grad(out, (xl, tl), gout))

    xc = x.permute(0, 3, 1, 2).detach().requires_grad_()  # NCHW view, channels-last strides
    wc = taps.permute(2, 0, 1).unsqueeze(1).contiguous().requires_grad_()
    gc = gout.permute(0, 3, 1, 2)

    def library_pass():
        out = F.conv2d(xc, wc, padding=(kh // 2, 1), groups=c)
        return torch.autograd.grad(out, (xc, wc), gc)

    results.record("dwconv", shape, time_ms(kernel_pass, runs, warmup),
                   time_ms(plain_pass, runs, warmup),
                   max(errors(g_, w_)[0] for g_, w_ in zip(got[:2], want[:2])),
                   max_rel(got[2], want[2]), library_ms=time_ms(library_pass, runs, warmup))


def time_kernels(cases, results, shapes, runs, warmup):
    """Each model kernel's case (:class:`KernelCases`) at each of its
    ``shapes`` (kernel name -> shapes: ``fps`` (B, N, S), ``correlation2d``
    (B, H, W, C, d), ``mdta_qkv`` (B, H, W, C, kh), ``gdfn`` (B, H, W, C),
    ``dwconv`` (B, H, W, C, kh), ``conv3x3`` (B, H, W, Cin, Cout, d)), timed
    against its plain version (median of ``runs`` after ``warmup``; the
    plain FPS, a loop of S steps, after one) and recorded in ``results``.
    The correlation's forward is timed alone, then its fused backward
    against the plain backward; the depthwise conv as :func:`dwconv_timed`
    times it. The decoder conv's plain version is the library call,
    ``F.conv2d`` (cuDNN's pick), and is recorded as both."""
    from rpeflow_tpu_torch.ops import conv3x3, correlation, fps, gdfn, mdta

    for b, n, s in shapes["fps"]:
        xyz = cases.fps(b, n, s)
        results.record("fps", (b, n, s),
                       time_ms(lambda: fps.furthest_point_sampling(xyz, s), runs, warmup),
                       time_ms(lambda: fps.furthest_point_sampling_plain(xyz, s), runs, 1),
                       0.0, 0.0)
    for b, h, w, c, d in shapes["correlation2d"]:
        f1, f2, g_, (out, ref), (grads, refs) = cases.corr(b, h, w, c, d)
        results.record("correlation2d", (b, h, w, c),
                       time_ms(lambda: correlation.correlation2d_fwd(f1, f2, d), runs, warmup),
                       time_ms(lambda: correlation.correlation2d_plain(f1, f2, d), runs, warmup),
                       *errors(out, ref))
        results.record("correlation2d_bwd", (b, h, w, c),
                       time_ms(lambda: correlation.correlation2d_bwd(f1, f2, g_, d), runs, warmup),
                       time_ms(lambda: correlation.correlation2d_bwd_plain(f1, f2, g_, d), runs,
                               warmup),
                       max(errors(a, r)[0] for a, r in zip(grads, refs)),
                       max(max_rel(a, r) for a, r in zip(grads, refs)))
    for shape in shapes["mdta_qkv"]:
        args, outs, refs = cases.mdta(*shape)
        results.record("mdta_qkv", shape, time_ms(lambda: mdta.mdta_qkv(*args), runs, warmup),
                       time_ms(lambda: mdta.mdta_qkv_plain(*args), runs, warmup),
                       errors(outs[0], refs[0])[0],
                       max(errors(o, r)[1] for o, r in zip(outs[1:], refs[1:])))
    for shape in shapes["gdfn"]:
        args, out, ref = cases.gdfn(*shape)
        results.record("gdfn", shape, time_ms(lambda: gdfn.gdfn(*args), runs, warmup),
                       time_ms(lambda: gdfn.gdfn_plain(*args), runs, warmup), *errors(out, ref))
    for shape in shapes["dwconv"]:
        dwconv_timed(results, cases, shape, runs, warmup)
    for shape in shapes.get("conv3x3", ()):
        x, weight, bias, out, ref = cases.conv3x3(*shape)
        d = shape[5]
        library_ms = time_ms(lambda: conv3x3.conv3x3_plain(x, weight, bias, d), runs, warmup)
        results.record("conv3x3", shape,
                       time_ms(lambda: conv3x3.conv3x3_fwd(x, weight, bias, d), runs, warmup),
                       library_ms, *errors(out, ref), library_ms=library_ms)


def phase_kernels(dev):
    """Each kernel vs its plain version at the flagship forward's and the
    training step's shapes (timed, summed, with bounds), then at edge shapes
    (ragged tiles, ties; checked only)."""
    from rpeflow_tpu_torch.ops import _cuda, conv3x3, correlation, dwconv, gdfn

    cases = KernelCases(dev, SEED)
    results = KernelRecords()
    # one FPS over both clouds stacked, [8, 8192, 3] -> 4096; the correlation
    # on the flagship's five decode levels (the training step's too); the
    # depthwise conv on the training step's shapes (dwconv_shapes); the
    # decoder's 3x3 convs at the flagship's 55 calls (the training step's too)
    shapes = {"fps": [(8, 8192, 4096)], "correlation2d": [(4, h, w, c, 4) for h, w, c, _ in LEVELS],
              "mdta_qkv": [], "gdfn": [], "dwconv": dwconv_shapes(),
              "conv3x3": conv3x3_shapes(4, 576, 960)}
    for h, w, c, n in LEVELS:
        shapes["mdta_qkv"] += [(8, h, w, c, 3), (4, h, w, 81, 3), (4, h, w, 96, 3),
                               (8, 1, n, c, 1), (4, 1, n, c, 1), (4, 1, n, 64, 1)]
        shapes["gdfn"] += [(8, h, w, c), (4, h, w, 81), (4, h, w, 96)]
    time_kernels(cases, results, shapes, runs=20, warmup=3)

    # edge shapes, checked and not timed: GDFN tiles cut by the image edge
    # (W = 15, 30, 60, 130, 160 against 30-column tiles; H not a multiple of
    # the 6- or 2-row tile) at every width class: B = 1 maps take 2-row
    # tiles, the larger ones 6-row tiles up to C = 96 (120 x 160 is a
    # quarter of DSEC's frame; the model resizes it, so its level 1 is
    # 128 x 160, phase 13); FPS with duplicated points and exact ties, N not a
    # multiple of the 512 threads, n_samples = N
    gdfn_edges = [(b, h, w, c) for c in (32, 64, 81, 96, 128, 192)
                  for b, h, w in ((1, 7, 15), (1, 13, 30), (1, 9, 60), (4, 120, 160),
                                  (8, 100, 130))]
    for shape in gdfn_edges:
        rows = gdfn.tile_rows(*shape)
        if rows != (6 if shape[0] > 1 and shape[3] <= 96 else 2):
            raise AssertionError(f"gdfn {shape}: {rows}-row tiles")
        cases.gdfn(*shape)
    fps_edges = ((2, 1000, 1000, True), (3, 3000, 1500, True), (4, 8191, 4096, True),
                 (2, 777, 777, False), (1, 5, 5, False), (1, 1, 1, False))
    for b, n, s, ties in fps_edges:
        cases.fps(b, n, s, ties)
    # MDTA: H and W not multiples of the 8-row tile and its 4/8/16 columns,
    # one token, a 120 x 160 map, point runs of N not a multiple of the
    # run, at every width (C = 192 in two Gram slices); then many tiles per
    # batch element, and a batch of more blocks than the card holds at once
    mdta_edges = [(b, h, w, c, kh) for c in (32, 64, 81, 96, 128, 192)
                  for b, h, w, kh in ((1, 1, 1, 3), (1, 7, 15, 3), (2, 13, 30, 3),
                                      (4, 120, 160, 3), (2, 1, 777, 1), (1, 1, 1, 1))]
    mdta_edges += [(8, 144, 240, 32, 3), (300, 1, 16, 192, 1)]
    for shape in mdta_edges:
        cases.mdta(*shape)
    # depthwise conv: each edge shape under the default plans, and under
    # plans of 7-row strips and 5 backward blocks (strips cut by the map's
    # edge, many units a block)
    sms = _cuda.sm_count(dev)
    for shape in DWCONV_EDGE_SHAPES:
        cases.dwconv(*shape)
        cases.dwconv(*shape, plans=(dwconv.dwconv_plan(*shape, sms, rh=7),
                                   dwconv.dwconv_plan(*shape, sms, backward=True, rh=7, nb=5)))
    # correlation: each edge shape under the default plans and under
    # CORR_EDGE_PLAN
    for shape in CORR_EDGE_SHAPES:
        cases.corr(*shape)
        cases.corr(*shape, plans=tuple(correlation.correlation_plan(
            *shape, backward=bwd, **CORR_EDGE_PLAN) for bwd in (False, True)))
    # the decoder conv: each edge shape under the default plan and every tile
    for shape in CONV3X3_EDGE_SHAPES:
        cases.conv3x3(*shape)
        for tile in conv3x3.TILES:
            cases.conv3x3(*shape, plan=conv3x3.conv3x3_plan(*shape, sms, tile=tile))
    print(f"  edge shapes: gdfn {len(gdfn_edges)} (C 32/64/81/96/128/192 x 2- and 6-row "
          f"tiles cut by the edge), fps {len(fps_edges)} (ties, ragged N, n_samples = N), "
          f"mdta {len(mdta_edges)} (tiles cut by the edge, one token, ragged point runs, "
          "C 32-192, a batch beyond one wave of blocks; two calls bitwise equal), dwconv "
          f"{2 * len(DWCONV_EDGE_SHAPES)} (tiles and strips cut by the edge, W = 1, H = 1, "
          "C 3-1020, ragged point runs, a batch beyond one wave of blocks; two backward calls "
          "bitwise equal), correlation "
          f"{2 * len(CORR_EDGE_SHAPES)} (tiles cut by the edge, C = 3, 20, 81, d = 0, 1, 4, "
          "B = 1, one pixel; two backward calls bitwise equal), conv3x3 "
          f"{6 * len(CONV3X3_EDGE_SHAPES)} (Cin 3-243 past the chunk, Cout past the tile, one "
          "pixel, d = 16 beyond the map, every tile; two calls bitwise equal): all within "
          "tolerance",
          flush=True)
    return results


def phase_card_vs_cpu(dev):
    """The whole slice on the card (kernels) and on the CPU (plain versions)."""
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_

    model = seeded_init_(RPEFlow(model_cfg(), REDUCED_SAMPLES), SEED)
    batch = make_batch(SEED + 1, device="cpu", **REDUCED)
    with torch.inference_mode():
        ref = model(batch)
        model.to(dev)
        out = model({k: t.to(dev) for k, t in batch.items()})
    atol = 2e-2
    bad = []
    for key in ("flow_2d", "flow_3d"):
        o, r = out[key].cpu().double(), ref[key].double()
        if not torch.isfinite(o).all():
            raise AssertionError(f"card vs CPU: non-finite {key}")
        d = (o - r).abs()
        frac = float((d <= atol + 1e-3 * r.abs()).double().mean())
        print(f"  {key}: {tuple(o.shape)}  within tol {frac:.4%}  mean|d| {float(d.mean()):.3e}"
              f"  max|d| {float(d.max()):.3e}", flush=True)
        if frac < 0.995 or float(d.mean()) >= atol:
            bad.append(key)
    if bad:
        raise AssertionError(f"card vs CPU: {bad} outside the tolerance model")


def check_launches(path, launches):
    missing = sorted(k for k in EXPECTED[path] if launches[k] == 0)
    if missing:
        raise AssertionError(f"{path}: kernels not launched: {missing}")


def phase_flagship(dev):
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.ops import _cuda
    from rpeflow_tpu_torch.train.evaluator import _metric_sums

    model = seeded_init_(RPEFlow(model_cfg(), N_SAMPLES), SEED).to(dev)
    keys = ("images", "pcs", "event_voxel", "intrinsics")
    batch = make_batch(SEED + 2, device=dev, targets=True, **FLAGSHIP)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        out = model({k: batch[k] for k in keys})
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        sums = {k: float(v) for k, v in _metric_sums(out, batch, True).items()}
    print(f"  launches in one forward: {launches}")
    check_launches("eval forward", launches)
    b, h, w, n = FLAGSHIP["b"], FLAGSHIP["h"], FLAGSHIP["w"], FLAGSHIP["n"]
    if tuple(out["flow_2d"].shape) != (b, h, w, 2) or tuple(out["flow_3d"].shape) != (b, n, 3):
        raise AssertionError(f"output shapes {[tuple(t.shape) for t in out.values()]}")
    for key, t in out.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"flagship {key} not finite")
    if not all(np.isfinite(v) for v in sums.values()):
        raise AssertionError(f"metric sums not finite: {sums}")
    print(f"  outputs finite; metric sums {sums}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_autograd(dev):
    """The autograd functions (kernels inside) against torch.autograd through
    their plain compositions, at one level-1 shape each: every gradient
    within 1e-4 of its largest entry."""
    from rpeflow_tpu_torch.ops import correlation, dwconv, gdfn, mdta

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    h, w, c, n = LEVELS[0]
    hid = int(2.66 * c)
    ln = torch.stack([1 + 0.1 * rnd(c), 0.1 * rnd(c), 1 + 0.1 * rnd(c), 0.1 * rnd(c)])
    cases = {
        "correlation2d": ((lambda a, b: correlation.correlation2d(a, b, 4)),
                          (lambda a, b: correlation.correlation2d_plain(a, b, 4)),
                          [rnd(4, h, w, c), rnd(4, h, w, c)]),
        "mdta": ((lambda *a: mdta.mdta_attention(*a, 3, 1)),
                 (lambda *a: mdta.mdta_attention_plain(*a, 3, 1)),
                 [rnd(4, h, w, c), rnd(4, h, w, c), ln, 0.3 * rnd(3, 3, 3 * c),
                  1 + 0.1 * rnd(1, 1, 1), rnd(c, c) / c ** 0.5]),
        "mdta points": ((lambda *a: mdta.mdta_attention(*a, 1, 1)),
                        (lambda *a: mdta.mdta_attention_plain(*a, 1, 1)),
                        [rnd(4, 1, n, c), rnd(4, 1, n, c), ln, 0.3 * rnd(1, 3, 3 * c),
                         1 + 0.1 * rnd(1, 1, 1), rnd(c, c) / c ** 0.5]),
        "gdfn": (gdfn.gdfn, gdfn.gdfn_plain,
                 [rnd(4, h, w, c), rnd(c, 2 * hid) / c ** 0.5, rnd(3, 3, 2 * hid) / 3,
                  rnd(hid, c) / hid ** 0.5]),
        "dwconv": (dwconv.dwconv, dwconv.dwconv_plain, [rnd(4, h, w, 2 * hid), rnd(3, 3, 2 * hid) / 3]),
    }
    for name, (fn, plain, inputs) in cases.items():
        grads = []
        for f in (fn, plain):
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            out = f(*leaves)
            if not grads:
                gout = torch.randn(out.shape, generator=g, device=dev)
            out.backward(gout)
            grads.append([t.grad for t in leaves])
        worst = max(max_rel(a, b) for a, b in zip(*grads))
        print(f"  {name:14s} {tuple(inputs[0].shape)}: largest gradient error "
              f"{worst:.3e} of the largest entry", flush=True)
        if worst > 1e-4:
            raise AssertionError(f"autograd {name}: gradient error {worst:.3e} > 1e-4")


def _grad_bound_ok(d, scale):
    """Per-leaf bound of tests/test_segmented_train.py."""
    return d <= 2e-3 * max(scale, 1.0) + 1e-4


def pre_norm_biases(model):
    """Names of the biases that feed a batch norm in training mode. The norm
    subtracts the batch mean, so their exact gradient is 0, and what either
    device computes for them is rounding noise of the gradients behind."""
    from rpeflow_tpu_torch.nn.layers import ConvNormAct
    from rpeflow_tpu_torch.nn.pointconv import PointConv

    names = set()
    for name, mod in model.named_modules():
        if getattr(mod, "norm", None) != "batch_norm":
            continue
        if isinstance(mod, ConvNormAct):
            names.add(f"{name}.conv_fn.bias")
        elif isinstance(mod, PointConv):
            names.add(f"{name}.linear.bias")
    return names


@contextlib.contextmanager
def shared_choices(tape, replay):
    """Within the block, the model's discrete choices -- the indices of every
    FPS and nearest-neighbour search, the sign test of every (leaky) ReLU --
    are recorded on ``tape`` (``replay`` False) or, each computed all the
    same, replaced by the recorded ones in call order (``replay`` True).
    The searches rank squared distances in the matmul form, which rounds at
    the scale of |q|^2, and an activation's input near 0 changes sign with
    the last bits of the conv before it, so near-ties fall differently on
    the card and on the CPU. One flipped leaky ReLU moves a conv's weight
    gradient by several times the per-leaf bound, so the devices are held
    to one computation: the same choices, each device's own arithmetic.
    Yields ``{"indices" | "signs": [differing, total]}``."""
    import importlib

    import torch.nn.functional as F

    counts = {"indices": [0, 0], "signs": [0, 0]}
    pos = iter(range(len(tape)))

    def share(kind, own):
        if not replay:
            tape.append(own)
            return own
        rec = tape[next(pos)].to(own.device)
        if rec.shape != own.shape:
            raise AssertionError(f"replayed {kind} {tuple(rec.shape)} vs {tuple(own.shape)}")
        counts[kind][0] += int((rec != own).sum())
        counts[kind][1] += own.numel()
        return rec

    def search(fn):
        return lambda *args: share("indices", fn(*args))

    def leaky_relu(x, negative_slope=0.01, inplace=False):
        return torch.where(share("signs", x.detach() > 0), x, negative_slope * x)

    def relu(x, inplace=False):
        return torch.where(share("signs", x.detach() > 0), x, torch.zeros_like(x))

    patches = [(F, "leaky_relu", leaky_relu), (F, "relu", relu)]
    for mod_name, names in {
            "rpeflow_tpu_torch.nn.pyramid3d": ("furthest_point_sampling", "k_nearest_neighbor"),
            "rpeflow_tpu_torch.nn.pointconv": ("k_nearest_neighbor",),
            "rpeflow_tpu_torch.ops.interp": ("k_nearest_neighbor",),
            "rpeflow_tpu_torch.model.core": ("k_nearest_neighbor",)}.items():
        mod = importlib.import_module(mod_name)
        patches += [(mod, name, search(getattr(mod, name))) for name in names]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# Largest share of the CPU's own discrete choices that may differ from the
# card's in phase 7 before the replay would hide a fault: about 4x and 40x
# the readings of 188 of 150,780 indices and 5 of 20.2M signs on an H100.
REPLAY_BOUND = {"indices": 5e-3, "signs": 1e-5}


def phase_train_card_vs_cpu(dev):
    """One train step (MI off) of the same model on the card and on the CPU,
    the CPU replaying the card's discrete choices (:func:`shared_choices`),
    whose own choices may differ in at most ``REPLAY_BOUND`` of them: loss rtol 1e-4, per-leaf gradients
    |d| <= 2e-3 max(|g|max, 1) + 1e-4, updated batch statistics rtol 1e-4,
    atol 1e-6. A bias that feeds a batch norm (exact gradient 0) is held
    instead to |g| <= 1e-6 of the largest gradient entry of the model, on
    both devices."""
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step

    cpu_model = seeded_init_(RPEFlow(model_cfg(), REDUCED_SAMPLES), SEED).train()
    card_model = copy.deepcopy(cpu_model).to(dev)
    batch = make_batch(SEED + 4, device="cpu", targets=True, **REDUCED)
    runs, tape = {}, []
    for name, model, device in (("card", card_model, dev), ("cpu", cpu_model, "cpu")):
        opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
        with shared_choices(tape, replay=name == "cpu") as counts:
            runs[name] = train_step(model, opt, {k: t.to(device) for k, t in batch.items()},
                                    None, compute_mi=False)
    ref, out = runs["cpu"], runs["card"]
    print("  the CPU's own choices differ from the card's (replayed): " + ", ".join(
        f"{k} {d} of {n} (bound {REPLAY_BOUND[k]:.0e} of them)"
        for k, (d, n) in counts.items()), flush=True)
    bad = [(f"replayed {k}", d, n) for k, (d, n) in counts.items()
           if not 0 < n or d > REPLAY_BOUND[k] * n]
    print("  " + "; ".join(f"{k} card {out[k]:.6f} cpu {ref[k]:.6f}"
                           for k in ("loss", "loss_2d", "loss_3d", "grad_norm")), flush=True)
    if not np.isfinite(out["loss"]) or abs(out["loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"]):
        bad.append(("loss", out["loss"], ref["loss"]))
    worst = 0.0
    cpu_params = dict(cpu_model.named_parameters())
    zero_grad = pre_norm_biases(cpu_model)
    g_max = max(float(p.grad.abs().max()) for p in cpu_params.values() if p.grad is not None)
    for name, p in card_model.named_parameters():
        g_ref = cpu_params[name].grad
        if g_ref is None:
            continue
        g = p.grad.cpu()
        if name in zero_grad:
            noise = max(float(g.abs().max()), float(g_ref.abs().max()))
            if noise > 1e-6 * g_max:
                bad.append((name, noise, g_max))
            continue
        d = float((g - g_ref).abs().max())
        scale = float(g_ref.abs().max())
        worst = max(worst, d / (2e-3 * max(scale, 1.0) + 1e-4))
        if not _grad_bound_ok(d, scale):
            bad.append((name, d, scale))
    print(f"  per-leaf gradients: worst |d| at {worst:.3f} of the bound; {len(zero_grad)} "
          f"pre-norm biases held to 1e-6 of the largest entry ({g_max:.3e})", flush=True)
    cpu_buffers = dict(cpu_model.named_buffers())
    n_stats = 0
    for name, buf in card_model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            if not torch.allclose(buf.cpu(), cpu_buffers[name], rtol=1e-4, atol=1e-6):
                bad.append((name, errors(buf.cpu(), cpu_buffers[name])[0], None))
    print(f"  {n_stats} updated batch statistics against rtol 1e-4, atol 1e-6; outside a bound: "
          f"{len(bad)}", flush=True)
    if bad:
        raise AssertionError(f"train step card vs CPU outside the bounds: {bad[:8]}")


def phase_train_flagship(dev):
    """conf/train/pretrain.yaml's model at the FT3D training shape, MI on."""
    from rpeflow_tpu_torch.compat import load_checkpoint
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.ops import _cuda
    from rpeflow_tpu_torch.train.checkpoint import save_checkpoint
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step

    model = seeded_init_(RPEFlow(model_cfg(), N_SAMPLES), SEED).to(dev).train()
    opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    train_step(model, opt, make_batch(SEED + 20, device=dev, targets=True, **TRAIN), gen)
    batches = [make_batch(SEED + 21 + i, device=dev, targets=True, **TRAIN) for i in range(5)]
    losses, launches = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, bt in enumerate(batches):
        if i == 0:
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
        summary = train_step(model, opt, bt, gen)
        if i == 0:
            torch.cuda.synchronize()
            launches = dict(_cuda.LAUNCHES)
        losses.append(summary)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / len(batches)
    print(f"  launches in one train step: {launches}")
    check_launches("train step", launches)
    if launches["correlation2d_bwd"] != len(LEVELS):
        raise AssertionError(f"train step: {launches['correlation2d_bwd']} correlation "
                             f"backward launches, {len(LEVELS)} expected")
    for i, sm in enumerate(losses):
        print(f"  step {i + 1}: loss {sm['loss']:.4f} (2d {sm['loss_2d']:.4f}, 3d "
              f"{sm['loss_3d']:.4f}, mi {sm['mi_loss']:.6f}), grad_norm {sm['grad_norm']:.3f}")
        if not all(np.isfinite(v) for v in sm.values()):
            raise AssertionError(f"flagship train step {i + 1}: non-finite summary {sm}")
        if sm["mi_loss"] == 0.0:
            raise AssertionError("flagship train step: MI loss is 0")
    b = TRAIN["b"]
    print(f"  flagship train step: {dt * 1e3:.2f} ms/step at batch {b} ({b / dt:.2f} "
          f"frame-pairs/s; 5 steps, inputs differ per step, MI on); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    after = {k: v.detach() for k, v in model.named_parameters()}
    moved = sum(float((after[k] - v).abs().max()) > 0 for k, v in before.items())
    temps = [k for k in before if k.endswith("temperature")]
    if any(not torch.equal(after[k], before[k]) for k in temps):
        raise AssertionError("the frozen MDTA temperature moved")
    print(f"  {moved} of {len(before)} parameters moved; {len(temps)} temperatures frozen")
    if moved < len(before) // 2:
        raise AssertionError("too few parameters moved")

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        train_step(model, opt, batches[0], gen)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(avgs.table(sort_by=key, row_limit=25))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.pt")
        save_checkpoint(path, model, opt, 1, None)
        eval_model = RPEFlow(model_cfg(), N_SAMPLES)
        load_checkpoint(eval_model, path, strict=True)
    print("  checkpoint saved and loaded strictly into the eval model", flush=True)
    return launches, {"ms_per_step": dt * 1e3, "batch": b,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


# Phases 9 and 10 run the reduced train step of phase 7 at batch 2 (one sample
# a rank in 9(b)), MI on, with this seed for the weights and the MI noise
DP = dict(REDUCED, b=2)
DP_SEED = SEED + 5


def step_breaches(record, ref_record, zero_grad):
    """Phase 7's bounds between two train steps' :func:`step_record`: loss
    rtol 1e-4, per-leaf gradients |d| <= 2e-3 max(|g|max, 1) + 1e-4, a bias
    that feeds a batch norm held to 1e-6 of the largest gradient entry on
    both sides, batch statistics rtol 1e-4, atol 1e-6. Returns the breaches
    and the worst gradient's share of its bound."""
    (out, grads, buffers), (ref, ref_grads, ref_buffers) = record, ref_record
    bad, worst = [], 0.0
    if not np.isfinite(out["loss"]) or abs(out["loss"] - ref["loss"]) > 1e-4 * abs(ref["loss"]):
        bad.append(("loss", out["loss"], ref["loss"]))
    g_max = max(float(g.abs().max()) for g in ref_grads.values())
    for name, g_ref in ref_grads.items():
        g = grads[name].cpu()
        if name in zero_grad:
            noise = max(float(g.abs().max()), float(g_ref.abs().max()))
            if noise > 1e-6 * g_max:
                bad.append((name, noise, g_max))
            continue
        d, scale = float((g - g_ref).abs().max()), float(g_ref.abs().max())
        worst = max(worst, d / (2e-3 * max(scale, 1.0) + 1e-4))
        if not _grad_bound_ok(d, scale):
            bad.append((name, d, scale))
    for name, buf in ref_buffers.items():
        if name.endswith(("running_mean", "running_var")) and not torch.allclose(
                buffers[name].cpu(), buf, rtol=1e-4, atol=1e-6):
            bad.append((name, errors(buffers[name].cpu(), buf)[0], None))
    return bad, worst


def step_record(model, summary):
    """(summary, gradients, buffers) of a model after a step, on the CPU."""
    return (summary, {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None},
            {k: b.cpu() for k, b in model.named_buffers()})


@contextlib.contextmanager
def one_rank_group(backend="nccl"):
    """A process group of this process alone, as torchrun's environment for
    one rank makes it (``parallel.maybe_initialize_distributed``)."""
    from rpeflow_tpu_torch.parallel import mesh
    from rpeflow_tpu_torch.parallel.dryrun import free_port

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not mesh.maybe_initialize_distributed("cuda", backend):
            raise AssertionError("no process group from a one-rank torchrun environment")
        yield
    finally:
        if mesh.is_distributed():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rank_rows(t, rank, b):
    """Rank ``rank``'s rows (one sample a rank) of a choice recorded on a
    global batch of ``b``: its batch row, or for the two frames' stacked
    searches (2b rows) its row of each frame."""
    if t.shape[0] == b:
        return t[rank:rank + 1]
    if t.shape[0] != 2 * b:
        raise AssertionError(f"recorded choice of {tuple(t.shape)} for a batch of {b}")
    return torch.cat([t[rank:rank + 1], t[b + rank:b + rank + 1]])


def _dp_rank(spec_path, out_dir):
    """Body of one gloo rank of phase 9(b) on the spec's device (cuda:0):
    the reduced step on its slice of the batch, replaying its rows of the
    one-process choices."""
    from rpeflow_tpu_torch.model import RPEFlow
    from rpeflow_tpu_torch.ops import _cuda
    from rpeflow_tpu_torch.parallel import mesh
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.precision import use_f32
    from rpeflow_tpu_torch.train.state import train_step

    use_f32()
    spec = torch.load(spec_path)
    dev = torch.device(spec["device"])
    mesh.maybe_initialize_distributed(dev, backend="gloo")
    rank = mesh.process_index()
    if dev.type == "cuda":
        _cuda.lib()  # built by the parent: loads it
    model = RPEFlow(model_cfg(), spec["n_samples"])
    model.load_state_dict(spec["state"])
    model.to(dev).train()
    mesh.replicate(model)
    opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
    batch = {k: t.to(dev) for k, t in mesh.shard_batch(spec["batch"]).items()}
    tape = [rank_rows(t, rank, len(spec["batch"]["images"])) for t in spec["tape"]]
    mesh.reset_collective_counts()
    with shared_choices(tape, replay=True) as counts:
        summary = train_step(model, opt, batch, torch.Generator(device=dev).manual_seed(DP_SEED))
    torch.save({"record": step_record(model, summary), "counts": counts,
                "params": {k: p.detach().cpu() for k, p in model.named_parameters()},
                "collectives": dict(mesh.COLLECTIVES)},
               os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def phase_dp_reduced(dev):
    """9(a): the reduced step at batch 2, MI on, inside a one-rank NCCL group
    against the same step with no group; 9(b): two gloo ranks on this card,
    one sample each, against the same no-group step. Phase 7's bounds
    (:func:`step_breaches`), the discrete choices replayed from the no-group
    run (:func:`shared_choices`, ``REPLAY_BOUND``), and 9(b)'s two ranks'
    parameters bitwise equal."""
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.parallel import mesh
    from rpeflow_tpu_torch.parallel.dryrun import spawn_ranks
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step

    init = seeded_init_(RPEFlow(model_cfg(), REDUCED_SAMPLES), DP_SEED).train()
    zero_grad = pre_norm_biases(init)
    batch = make_batch(DP_SEED, device="cpu", targets=True, **DP)

    def run(tape, replay):
        model = copy.deepcopy(init).to(dev)
        opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
        with shared_choices(tape, replay=replay) as counts:
            summary = train_step(model, opt, {k: t.to(dev) for k, t in batch.items()},
                                 torch.Generator(device=dev).manual_seed(DP_SEED))
        return step_record(model, summary), counts

    tape = []
    ref, _ = run(tape, replay=False)
    if not ref[0]["mi_loss"]:
        raise AssertionError("9(a): the MI loss is 0")
    with one_rank_group():
        mesh.reset_collective_counts()
        out, counts = run(tape, replay=True)
        collectives = dict(mesh.COLLECTIVES)
    bad, worst = step_breaches(out, ref, zero_grad)
    print(f"  9(a) one-rank NCCL group vs no group: loss {out[0]['loss']:.6f} vs "
          f"{ref[0]['loss']:.6f}, grad_norm {out[0]['grad_norm']:.6f} vs "
          f"{ref[0]['grad_norm']:.6f}; worst gradient at {worst:.3f} of its bound; replayed "
          f"choices differing from its own: {counts}; collectives in one step: {collectives}",
          flush=True)
    if bad or any(d > REPLAY_BOUND[k] * n for k, (d, n) in counts.items()):
        raise AssertionError(f"9(a) outside the bounds: {bad[:8]}, {counts}")

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.pt")
        torch.save({"state": init.state_dict(), "batch": batch, "device": str(dev),
                    "n_samples": REDUCED_SAMPLES, "tape": [t.cpu() for t in tape]}, spec)
        t0 = time.perf_counter()
        spawn_ranks(_dp_rank, 2, spec, tmp)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    print(f"  9(b) two gloo ranks on {dev}, batch 1 each ({time.perf_counter() - t0:.1f} s "
          f"with start-up): collectives of rank 0: {ranks[0]['collectives']}", flush=True)
    bad = []
    for r, res in enumerate(ranks):
        breaches, worst = step_breaches(res["record"], ref, zero_grad)
        print(f"  rank {r}: loss {res['record'][0]['loss']:.6f} vs one process "
              f"{ref[0]['loss']:.6f}; worst gradient at {worst:.3f} of its bound; replayed "
              f"choices differing from its own: {res['counts']}", flush=True)
        bad += breaches + [(f"rank {r} replayed {k}", d, n) for k, (d, n) in res["counts"].items()
                           if d > REPLAY_BOUND[k] * n]
    unequal = [k for k, p in ranks[0]["params"].items()
               if not torch.equal(p, ranks[1]["params"][k])]
    if bad or unequal:
        raise AssertionError(f"9(b) outside the bounds: {bad[:8]}; parameters unequal across "
                             f"ranks: {unequal[:8]}")
    print(f"  9(b): both ranks within phase 7's bounds of one process at batch 2; "
          f"{len(ranks[0]['params'])} parameters bitwise equal across the ranks", flush=True)


def flagship_steps(dev, label, amp=False, steps=3):
    """One warm-up and ``steps`` timed train steps of phase 8's model and
    shape (MI on); every kernel of the path launched in the first timed step
    (counts set to 0 just before it, read just after). Returns ms/step and
    the peak GiB."""
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.ops import _cuda
    from rpeflow_tpu_torch.parallel import mesh
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step

    model = seeded_init_(RPEFlow(model_cfg(), N_SAMPLES, amp=amp), SEED).to(dev).train()
    opt = optimizer_factory(training_cfg(), model, steps_per_epoch=100)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_step(model, opt, make_batch(SEED + 20, device=dev, targets=True, **TRAIN), gen)
    batches = [make_batch(SEED + 21 + i, device=dev, targets=True, **TRAIN) for i in range(steps)]
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    mesh.reset_collective_counts()
    t0 = time.perf_counter()
    summaries = []
    for i, bt in enumerate(batches):
        summaries.append(train_step(model, opt, bt, gen))
        if i == 0:
            torch.cuda.synchronize()
            launches, collectives = dict(_cuda.LAUNCHES), dict(mesh.COLLECTIVES)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    check_launches("train step", launches)
    for i, sm in enumerate(summaries):
        if not all(np.isfinite(v) for v in sm.values()) or sm["mi_loss"] == 0.0:
            raise AssertionError(f"{label} step {i + 1}: {sm}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {label}: launches in one step {launches}; collectives {collectives}; losses "
          f"{[round(sm['loss'], 4) for sm in summaries]}", flush=True)
    return dt * 1e3, peak


def phase_dp_flagship(dev, phase8):
    """9(c): phase 8's training through a one-rank NCCL group."""
    with one_rank_group():
        ms, peak = flagship_steps(dev, "9(c) one-rank NCCL group")
    b = TRAIN["b"]
    print(f"  9(c) flagship train step in a one-rank NCCL group: {ms:.2f} ms/step at batch {b} "
          f"(1 warm-up, 3 timed steps, MI on); peak device memory {peak:.2f} GiB; phase 8 "
          f"without a group: {phase8['ms_per_step']:.2f} ms/step, {phase8['peak_gib']:.2f} GiB",
          flush=True)


def phase_amp(dev):
    """amp on the card, at phase 4's shape against the CPU: each 2-D
    pyramid level's bfloat16 output within 2^-6 of the level's largest entry
    (4 bfloat16 steps there) and nearer, in mean |d|, to the CPU's amp output
    than the CPU's float32 output is; the amp forward's flows in phase 4's
    tolerance model; forward hooks showing that only the two 2-D pyramids
    return bfloat16. Then phase 8's training with amp."""
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_

    batch = make_batch(SEED + 1, device="cpu", **REDUCED)
    f32 = seeded_init_(RPEFlow(model_cfg(), REDUCED_SAMPLES), SEED)
    amp = seeded_init_(RPEFlow(model_cfg(), REDUCED_SAMPLES, amp=True), SEED)
    inputs = {"feature_pyramid_2d": batch["images"][..., :3].float() / 255.0,
              "efeature_pyramid_2d": batch["event_voxel"]}
    bad = []
    with torch.inference_mode():
        for name, x in inputs.items():
            pyramids = [getattr(m.pwc_fusion_core, name) for m in (amp, f32)]
            ref, ref_f32 = (pyr(x) for pyr in pyramids)
            out = getattr(copy.deepcopy(amp).to(dev).pwc_fusion_core, name)(x.to(dev))
            for level, (o, r, r32) in enumerate(zip(out, ref, ref_f32)):
                d, d_bf16 = (o.cpu().double() - r.double()).abs(), (r32 - r.double()).abs()
                print(f"  amp {name} level {level}: {o.dtype}, card vs CPU max|d| "
                      f"{float(d.max()):.3e} of {float(r.abs().max()):.3f}, mean|d| "
                      f"{float(d.mean()):.3e}; the CPU's f32 vs amp mean|d| "
                      f"{float(d_bf16.mean()):.3e}", flush=True)
                if (o.dtype != torch.bfloat16 or not float(d.mean()) < float(d_bf16.mean())
                        or float(d.max()) > 2.0 ** -6 * float(r.abs().max())):
                    bad.append((name, level))
        ref = amp(batch)
    amp.to(dev)
    dtypes = {}
    names = {m: n for n, m in amp.named_modules()}

    def hook(module, args, output):
        outs = output if isinstance(output, (list, tuple)) else [output]
        dtypes.setdefault(names[module], set()).update(
            t.dtype for t in outs if torch.is_tensor(t) and t.is_floating_point())

    handles = [m.register_forward_hook(hook) for m in names]
    try:
        with torch.inference_mode():
            out = amp({k: t.to(dev) for k, t in batch.items()})
    finally:
        for h in handles:
            h.remove()
    for key in ("flow_2d", "flow_3d"):
        o, r = out[key].cpu().double(), ref[key].double()
        d = (o - r).abs()
        frac = float((d <= 2e-2 + 1e-3 * r.abs()).double().mean())
        print(f"  amp {key}: card vs CPU within phase 4's tolerance {frac:.4%}, mean|d| "
              f"{float(d.mean()):.3e}, max|d| {float(d.max()):.3e}", flush=True)
        if out[key].dtype != torch.float32 or not torch.isfinite(o).all() or frac < 0.995 \
                or float(d.mean()) >= 2e-2:
            bad.append(key)
    pyramids = ("pwc_fusion_core.feature_pyramid_2d.", "pwc_fusion_core.efeature_pyramid_2d.")
    in_scope = {n for n in dtypes if f"{n}.".startswith(pyramids)}
    wrong = [(n, s) for n, s in dtypes.items()
             if not s <= ({torch.bfloat16} if n in in_scope else {torch.float32})]
    print(f"  forward hooks: {len(in_scope)} modules of the two 2-D pyramids returned bfloat16, "
          f"{len(dtypes) - len(in_scope)} others float32; outside that: {wrong[:4]}", flush=True)
    if bad or wrong or len(in_scope) < 30:
        raise AssertionError(f"amp card vs CPU: {bad}; dtypes {wrong[:8]}")
    ms, peak = flagship_steps(dev, "amp flagship training", amp=True)
    print(f"  amp flagship train step: {ms:.2f} ms/step at batch {TRAIN['b']} (1 warm-up, 3 "
          f"timed steps, MI on); peak device memory {peak:.2f} GiB", flush=True)


# (B, N, M, C, table dtype, index dtype, indices) the gathers are checked at
# beyond the tool's shape: C of one, three, five, eight, 81 and 256 floats
# (rows copied 4 or 16 bytes at a time; C = 5 leaves the lane gather's last
# channel group short), bfloat16 rows (2 and 16 bytes), M = 1 and 2047 (the
# lane gather's walk one m a thread), N = 1, B = 1, int64 indices, every
# index repeated, only 0 and N - 1, N = 65,536 (f32 rows too long for shared
# memory: the lane gather's L2 branch; bf16 rows of 128 KB, one a block),
# and tables one element past a 16-byte boundary (the staged lane gather's
# plain loads, not the TMA's)
GATHER_EDGE_SHAPES = [(4, 8192, 2048, c, torch.float32, torch.int32, "random")
                      for c in (1, 3, 5, 8, 81, 256)]
GATHER_EDGE_SHAPES += [
    (4, 8192, 2048, 128, torch.bfloat16, torch.int32, "random"),
    (2, 8192, 2048, 128, torch.bfloat16, torch.int64, "random"),
    (3, 8192, 2047, 5, torch.bfloat16, torch.int64, "random"),
    (2, 300, 2047, 3, torch.bfloat16, torch.int64, "random"),
    (4, 8192, 2047, 128, torch.float32, torch.int32, "random"),
    (3, 500, 1, 128, torch.float32, torch.int32, "random"),
    (2, 1, 2047, 81, torch.float32, torch.int64, "random"),
    (1, 8192, 131072, 128, torch.float32, torch.int32, "repeated"),
    (2, 777, 2047, 64, torch.float32, torch.int32, "ends"),
    (2, 65536, 2048, 8, torch.float32, torch.int32, "random"),
    (2, 65536, 2047, 5, torch.bfloat16, torch.int64, "random"),
    (4, 8192, 2048, 128, torch.float32, torch.int32, "misaligned"),
    (2, 8192, 2048, 5, torch.bfloat16, torch.int64, "misaligned"),
]
#: [B, H, W, C], tile_h the zero store is checked at beyond the repro's
#: [2, 144, 240, 256], 8: W * C not a multiple of 4 (4-byte stores at the
#: span's tail), one tile of the whole map, one element, and a span of
#: 798,795 floats, no multiple of a block's 16 KB and 3 floats past its
#: last 16-byte word
ZERO_EDGE_SHAPES = [((1, 8, 3, 5), 8), ((3, 16, 7, 9), 4), ((2, 144, 240, 256), 144),
                    ((1, 1, 1, 1), 1), ((3, 45, 97, 61), 9)]


def offset_copy(t):
    """A contiguous copy of ``t`` that starts one element past the start of
    its storage (so not 16-byte aligned)."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return view.copy_(t)


def gather_case(b, n, m, c, dtype, idx_dtype, kind, g):
    """Both gathers against their plain versions, exactly; returns each
    one's max |kernel - plain|."""
    from rpeflow_tpu_torch.ops import gather

    dev = g.device
    table = torch.randn(b, n, c, generator=g, device=dev).to(dtype)
    if kind == "repeated":
        idx = torch.randint(0, n, (b, 1), generator=g, device=dev).expand(b, m)
    elif kind == "ends":
        idx = (torch.randint(0, 2, (b, m), generator=g, device=dev) * (n - 1))
    else:
        idx = torch.randint(0, n, (b, m), generator=g, device=dev)
    idx = idx.to(idx_dtype).contiguous()
    table_cf = table.transpose(1, 2).contiguous()
    if kind == "misaligned":
        table, table_cf = offset_copy(table), offset_copy(table_cf)
    errs = {}
    for name, got, want in (
            ("gather_rows", gather.gather_rows(table, idx),
             gather.gather_rows_plain(table, idx)),
            ("gather_lanes", gather.gather_lanes(table_cf, idx),
             gather.gather_lanes_plain(table_cf, idx))):
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name} {(b, n, m, c, dtype, idx_dtype, kind)}: differs "
                                 "from the plain version")
        errs[name] = float((got.float() - want.float()).abs().max())
    return errs


def phase_tools(dev):
    """11: the tools. (a) the gather tool (every variant held exactly to the
    plain version, then timed) and both gathers at edge shapes; (b) the
    zero store against its plain version, the repro graph FINITE with the
    store's output discarded and added; (c) the native voxelizers against
    the numpy ones at DSEC scale; (d) the profile of the flagship forward;
    (e) two flagship train steps through the train-step tool; (f) the KNN-1
    bench, (g) the convex bench and (h) the resample study, each in a fresh
    process, checked from its last line. Returns the
    kernels' records and their launches per tool call."""
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    sys.path.insert(0, scripts)
    import torch_bench_gather
    import torch_bench_loader
    import torch_bench_train_step
    import torch_profile_forward
    import torch_repro_custom_call

    from rpeflow_tpu_torch.ops import _cuda, gather, zero_store

    records, launches = {}, {}

    # the profiler's device ms and the host's us a call of each tool kernel
    # and its library call, from the tools probe in a fresh process (in this
    # one, after phases 3-10, the profiler hands back few kernel records)
    torch.cuda.empty_cache()
    probe = subprocess.run([sys.executable, os.path.join(scripts, "torch_tools_probe.py"), "--json"],
                           capture_output=True, text=True, timeout=300)
    if probe.returncode != 0:
        raise AssertionError(f"torch_tools_probe.py failed:\n{probe.stdout}\n{probe.stderr}")
    print(probe.stdout, end="", flush=True)
    split = json.loads(probe.stdout.strip().splitlines()[-1])

    def record(name, shape, ms, plain_ms, library_ms, abs_err, library):
        kern, lib = split[name], split[library]
        b_ms, by = bound(*kernel_work(name, shape))
        records[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                         "max_abs_err": abs_err, "bound_ms": b_ms, "bound": {by: b_ms},
                         "device_ms": kern["device_ms"], "host_us": kern["host_us"],
                         "library_device_ms": lib["device_ms"], "library_host_us": lib["host_us"]}
        print(f"  {name:14s} {str(shape):28s} kernel {ms:9.4f} ms (device "
              f"{kern['device_ms']:.4f} ms, host {kern['host_us']:.1f} us)  plain {plain_ms:9.4f} "
              f"ms  library {library_ms:9.4f} ms (device {lib['device_ms']:.4f} ms, host "
              f"{lib['host_us']:.1f} us)  bound {b_ms:8.4f} ms ({by})  max |d| {abs_err}",
              flush=True)

    # (a) the gather tool, counts from 0 just before the call, read just after
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    res, _ = torch_bench_gather.run(list("abcde"), 4, 8192, 16, 128, dev, device_time=False)
    torch.cuda.synchronize()
    launches["gather tool"] = dict(_cuda.LAUNCHES)
    check_launches("gather tool", launches["gather tool"])
    table, table_cf, idx = torch_bench_gather.make_inputs(4, 8192, 16, 128, dev)
    shape = (4, 8192, idx.shape[1], 128, 4)
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    edge_errs = [gather_case(*case, g) for case in GATHER_EDGE_SHAPES]
    record("gather_rows", shape, res["c"][0],
           time_ms(lambda: gather.gather_rows_plain(table, idx)), res["a"][0],
           max([res["c"][2]] + [e["gather_rows"] for e in edge_errs]), "torch.gather rows")
    record("gather_lanes", shape, res["d"][0],
           time_ms(lambda: gather.gather_lanes_plain(table_cf, idx)), res["b"][0],
           max([res["d"][2]] + [e["gather_lanes"] for e in edge_errs]), "torch.gather lanes")
    print(f"  gathers at {len(GATHER_EDGE_SHAPES)} edge shapes (C 1-256, bfloat16, M = 1 and "
          "2047, N = 1 and 65,536, B = 1, int64 indices, repeated indices, indices 0 and N - 1, "
          "misaligned tables): equal", flush=True)

    # (b) the zero store, then the repro graph through its tool
    x = torch.randn(2, 144, 240, 256, generator=g, device=dev)
    zero_err = 0.0
    for shape, th in [((2, 144, 240, 256), 8)] + ZERO_EDGE_SHAPES:
        xs = x if shape == (2, 144, 240, 256) else torch.randn(*shape, generator=g, device=dev)
        got, want = zero_store.zero_store(xs, th), zero_store.zero_store_plain(xs, th)
        if not torch.equal(got, want):
            raise AssertionError(f"zero_store {shape} tile_h {th}: not all zeros")
        zero_err = max(zero_err, float((got - want).abs().max()))
    try:
        zero_store.zero_store(x[:, :143].contiguous(), 8)
    except ValueError:
        pass
    else:
        raise AssertionError("zero_store took H = 143 with tile_h = 8")

    record("zero_store", tuple(x.shape), time_ms(lambda: zero_store.zero_store(x, 8)),
           time_ms(lambda: zero_store.zero_store_plain(x, 8)),
           time_ms(lambda: torch.zeros(x.shape, device=dev)), zero_err, "torch.zeros")
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    rcs = [torch_repro_custom_call.main(a) for a in ([], ["--no-discard"])]
    torch.cuda.synchronize()
    launches["repro tool"] = {k: v // 2 for k, v in _cuda.LAUNCHES.items()}
    check_launches("repro tool", launches["repro tool"])
    if rcs != [0, 0]:
        raise AssertionError(f"the repro graph is not finite: exit codes {rcs}")

    # (c) the native voxelizers at DSEC scale (host only)
    vox = torch_bench_loader.voxelizers(500_000, repeats=5)

    # (d) the profile of the flagship forward
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_profile_forward.tsv")
    prof = torch_profile_forward.main(["--runs", "2", "--top", "15", "--out", out])
    hand = {c for run in prof["categories"] for c in run if c.startswith("kernel ")}
    want = {f"kernel {k}" for k in EXPECTED["eval forward"]}
    shares = prof["busy_share"]
    if not want <= hand or len(shares) != 2 or not all(share > 0 for share in shares):
        raise AssertionError(f"profile: hand kernels {sorted(hand)}, busy {shares}")

    # (e) the train-step tool, two timed steps
    if torch_bench_train_step.main(["--iters", "2"]) != 0:
        raise AssertionError("the train-step tool's summaries are not finite")

    # (f)-(h) the KNN-1 and convex benches and the resample study, each in a
    # process of its own (this one's cached blocks handed back first)
    torch.cuda.empty_cache()
    knn = run_tool(scripts, "torch_bench_knn1.py")["knn1"]
    off = {name: r["match"] for name, r in knn.items() if r["match"] != 1.0}
    if off or not all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in knn.values()):
        raise AssertionError(f"KNN-1 bench: match fractions below 1.0 {off}, or a time not "
                             f"finite: {knn}")
    convex = run_tool(scripts, "torch_bench_convex.py")["convex"]
    if not all(r["max_abs_err"] < 1e-4 and np.isfinite(r["ms"]) for r in convex.values()):
        raise AssertionError(f"convex bench: {convex}")
    study = run_tool(scripts, "torch_quantify_eval_deviations.py")
    values = [v for m in study["per_seed"] for v in m.values()]
    values += [v[key] for v in study["spread"].values() for key in ("mean", "spread")]
    missing = sorted(k for k in EXPECTED["eval forward"] if not study["launches"].get(k))
    if len(study["per_seed"]) != 3 or not np.all(np.isfinite(values)) or missing:
        raise AssertionError(f"resample study: metrics {study['per_seed']}, kernels not "
                             f"launched {missing}")
    return records, launches, vox


def run_tool(scripts, name, timeout=300):
    """Run ``scripts/<name>`` (on the card, its defaults) in a fresh process,
    print its output, and return the JSON object of its last line."""
    proc = subprocess.run([sys.executable, os.path.join(scripts, name)], capture_output=True,
                          text=True, timeout=timeout, cwd=os.path.dirname(scripts))
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"{name} failed (exit {proc.returncode}):\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_bench():
    """12: the bench twice, each run in a fresh process (this one's cached
    blocks handed back first), checked by ``bench.parse_output``."""
    from rpeflow_tpu_torch.bench import parse_output

    root = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for i in range(2):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "rpeflow_tpu_torch.bench", "--workload",
                               "all"], capture_output=True, text=True, timeout=900, cwd=root)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"bench run {i + 1} failed (exit {proc.returncode}):\n"
                                 f"{proc.stderr[-6000:]}")
        runs.append(parse_output(proc.stdout)[1])
        print(f"  bench run {i + 1}: {time.perf_counter() - t0:.1f} s", flush=True)
    for name in runs[0]:
        a, b = (r[name] for r in runs)
        print(f"  {name}: median {a['ms_median']:.2f} | {b['ms_median']:.2f} ms (q1-q3 "
              f"{a['ms_q1']:.2f}-{a['ms_q3']:.2f} | {b['ms_q1']:.2f}-{b['ms_q3']:.2f}), "
              f"{a['metric']} {a['value']:.4f} | {b['value']:.4f} {a['unit']}, mfu "
              f"{a['mfu']:.5f} | {b['mfu']:.5f}", flush=True)


# Phase 13: DSEC, the real-data benchmark its users evaluate on
# (conf/test/dsec.yaml, conf/train/dsec.yaml). (d) runs DSEC's 3:4 frames at
# about phase 4's pixel count, 144x192, resized to 192x192 inside as 480x640
# is to 512x640, with phase 4's 2048 points and n_samples.
DSEC_REDUCED = dict(b=1, h=144, w=192, n=2048, event_ch=20)
# conf/train/dsec.yaml's batch_size, the global batch of upstream's 4 GPUs;
# (b) runs it on one card too, to see whether it fits
DSEC_GLOBAL_BATCH = 12
DSEC_SEED = SEED + 30


def counted_runs(fn):
    """``fn()`` 3 times, each timed on the host clock between two
    synchronisations, the first with the launch counts set to 0 just before
    it and read just after. Returns the ms, the results and the launches."""
    from rpeflow_tpu_torch.ops import _cuda

    ms, outs = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            _cuda.reset_launch_counts()
        outs.append(fn())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            launches = dict(_cuda.LAUNCHES)
    return ms, outs, launches


def warm_up_recording(fn):
    """``fn()`` once under ``utils/flops.py : FlopCount``; returns the kernel
    wrapper calls it recorded, ``(name, shape)`` each."""
    from rpeflow_tpu_torch.utils.flops import FlopCount

    with FlopCount() as count:
        fn()
    return count.calls


def path_shapes(path, shapes, launches, expected):
    """Check a path's launches against ``expected`` (the bench's counts), and
    the wrapper calls recorded in a warm-up of the same path against them;
    the distinct shapes by kernel (the depthwise conv's forward and backward
    shapes under ``dwconv``)."""
    bad = {k: (launches[k], n) for k, n in expected.items() if launches[k] != n}
    calls = {}
    for name, _ in shapes:
        kern = "dwconv" if name == "dwconv_bwd" else name
        calls[kern] = calls.get(kern, 0) + 1
    if bad or any(calls.get(k, 0) != n for k, n in expected.items()):
        raise AssertionError(f"DSEC {path}: launches (got, expected) {bad}; wrapper calls "
                             f"recorded {calls}")
    distinct = {}
    for name, shape in shapes:
        if name == "dwconv_bwd":
            name, shape = "dwconv", shape[:5]
        distinct.setdefault(name, dict.fromkeys(()))[shape] = None
    return distinct


def phase_dsec(dev):
    """13: DSEC on the card. (a) the eval forward at DSEC_EVAL and (b) the
    fine-tune step at DSEC_TRAIN (MI on, l1, Adam), then at
    DSEC_GLOBAL_BATCH, each with its launches, ms and peak memory; (c)
    every model kernel against its plain version at every distinct shape
    (a) and (b) at DSEC_TRAIN gave it; (d) card against CPU at
    DSEC_REDUCED, the forward with its metric sums and one l1 step."""
    from rpeflow_tpu_torch.bench import EVAL_LAUNCHES
    from rpeflow_tpu_torch.flagship import DSEC_EVAL, DSEC_TRAIN, make_dsec_batch
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.train.evaluator import MODEL_KEYS, SUM_KEYS, _metric_sums

    report = {"card": timing.card_line(dev)}

    # (a) the eval forward, conf/test/dsec.yaml's model at batch 3, 480x640
    torch.cuda.empty_cache()
    model = seeded_init_(RPEFlow(model_cfg("l1"), N_SAMPLES), DSEC_SEED).to(dev)
    batch = make_dsec_batch(DSEC_SEED, device=dev, targets=True, **DSEC_EVAL)
    inputs = {k: batch[k] for k in MODEL_KEYS}
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        shapes = warm_up_recording(lambda: model(inputs))
        ms, outs, launches = counted_runs(lambda: model(inputs))
        out = outs[-1]
        sums = {k: float(v) for k, v in _metric_sums(out, batch, False).items()}
    eval_shapes = path_shapes("eval forward", shapes, launches, EVAL_LAUNCHES)
    b, h, w, n = (DSEC_EVAL[k] for k in "bhwn")
    if tuple(out["flow_2d"].shape) != (b, h, w, 2) or tuple(out["flow_3d"].shape) != (b, n, 3):
        raise AssertionError(f"DSEC output shapes {[tuple(t.shape) for t in out.values()]}")
    if not all(torch.isfinite(t).all() for t in out.values()):
        raise AssertionError("DSEC forward: flows not finite")
    valid = float(batch["flow_2d"][..., 2].sum())
    if (tuple(sums) != SUM_KEYS or not all(np.isfinite(v) for v in sums.values())
            or sums["2d/counts"] != valid or sums["3d/counts"] != b * n):
        raise AssertionError(f"DSEC metric sums {sums}; {valid} valid pixels, {b * n} points")
    report["eval"] = {"ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": {k: launches[k] for k in EVAL_LAUNCHES}}
    print(f"  (a) DSEC eval forward, batch {b}, {h}x{w}, {n} + {n} points: launches "
          f"{report['eval']['launches']}; ms {[round(t, 2) for t in ms]}; peak device memory "
          f"{report['eval']['peak_gib']:.2f} GiB; outputs finite; metric sums (sparse 2-D "
          f"ground truth, {valid:.0f} of {b * h * w} pixels valid, no occlusion split) {sums}",
          flush=True)
    del model, batch, inputs, outs, out

    # (b) the fine-tune step, conf/train/dsec.yaml's model and Adam, MI on, at
    # the per-GPU batch, then at upstream's global batch on this one card
    report["train"], train_shapes = dsec_steps(dev, DSEC_TRAIN)
    report["train_global_batch"], _ = dsec_steps(dev, dict(DSEC_TRAIN, b=DSEC_GLOBAL_BATCH))

    # (c) each kernel against its plain version at every distinct DSEC shape
    torch.cuda.empty_cache()
    report["kernels"] = phase_dsec_kernels(dev, eval_shapes, train_shapes)

    # (d) card against CPU at DSEC_REDUCED
    report["card_vs_cpu"] = dsec_card_vs_cpu(dev)
    print(json.dumps({"dsec": report}), flush=True)


def dsec_steps(dev, shape):
    """13(b): the DSEC fine-tune step (l1, MI on, Adam) at ``shape``: 1
    warm-up, its kernel wrapper calls recorded, and 3 timed steps, the
    first counted; launches, finite losses, parameters moved, peak memory.
    Returns the report entry and the distinct shapes by kernel."""
    from rpeflow_tpu_torch.bench import TRAIN_LAUNCHES
    from rpeflow_tpu_torch.flagship import dsec_training_cfg, make_dsec_batch
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step

    torch.cuda.empty_cache()
    model = seeded_init_(RPEFlow(model_cfg("l1"), N_SAMPLES), DSEC_SEED).to(dev).train()
    opt = optimizer_factory(dsec_training_cfg(), model, steps_per_epoch=100)
    gen = torch.Generator(device=dev).manual_seed(DSEC_SEED)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    batches = [make_dsec_batch(DSEC_SEED + 1 + i, device=dev, targets=True, **shape)
               for i in range(4)]
    calls = warm_up_recording(lambda: train_step(model, opt, batches[0], gen))
    it = iter(batches[1:])
    ms, summaries, launches = counted_runs(lambda: train_step(model, opt, next(it), gen))
    b = shape["b"]
    distinct = path_shapes(f"train step at batch {b}", calls, launches, TRAIN_LAUNCHES)
    for i, sm in enumerate(summaries):
        if not all(np.isfinite(v) for v in sm.values()) or sm["mi_loss"] == 0.0:
            raise AssertionError(f"DSEC train step {i + 1} at batch {b}: {sm}")
    after = dict(model.named_parameters())
    moved = sum(not torch.equal(after[k].detach(), v) for k, v in before.items())
    if moved < len(before) // 2:
        raise AssertionError(f"DSEC train step at batch {b}: {moved} of {len(before)} "
                             "parameters moved")
    entry = {"b": b, "ms": ms, "samples_per_s": [1e3 * b / t for t in ms],
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "launches": {k: launches[k] for k in TRAIN_LAUNCHES}}
    print(f"  (b) DSEC fine-tune step (l1, MI on, Adam 1e-4), batch {b}, {shape['h']}x"
          f"{shape['w']}: launches {entry['launches']}; ms/step {[round(t, 2) for t in ms]} "
          f"(samples/s {[round(r, 2) for r in entry['samples_per_s']]}); peak device memory "
          f"{entry['peak_gib']:.2f} GiB; losses {[round(sm['loss'], 4) for sm in summaries]}; "
          f"{moved} of {len(before)} parameters moved", flush=True)
    del model, opt, batches, before, after
    return entry, distinct


def phase_dsec_kernels(dev, *paths):
    """13(c): each model kernel against its plain version (phase 3's cases
    and tolerances, :func:`time_kernels`) at every distinct shape of
    ``paths`` (kernel -> shapes), timed (median of 5 after 1 warm-up)."""
    distinct = {}
    for path in paths:
        for name, shapes in path.items():
            distinct.setdefault(name, dict.fromkeys(())).update(shapes)
    distinct.pop("correlation2d_bwd", None)  # the forward's case runs the backward too
    gdfn_shapes = dict.fromkeys(())
    for b, h, w, c, hidden in distinct.pop("gdfn"):
        if hidden != int(2.66 * c):
            raise AssertionError(f"gdfn {(b, h, w, c)}: hidden {hidden}")
        gdfn_shapes[(b, h, w, c)] = None
    distinct["gdfn"] = gdfn_shapes
    unknown = set(distinct) - {"fps", "correlation2d", "mdta_qkv", "gdfn", "dwconv", "conv3x3"}
    if unknown:
        raise AssertionError(f"DSEC shapes of kernels with no case: {sorted(unknown)}")
    results = KernelRecords()
    time_kernels(KernelCases(dev, DSEC_SEED), results, distinct, runs=5, warmup=1)
    for name, r in results.items():
        print(f"  (c) {name:17s} {r['shapes']:3d} DSEC shapes: kernel {r['ms']:9.4f} ms, plain "
              f"{r['plain_ms']:9.4f} ms, bound {r['bound_ms']:8.4f} ms, library "
              f"{r['library_ms']} ms, max|d| {r['max_abs_err']:.3e} (sums over the shapes)",
              flush=True)
    return dict(results)


def dsec_card_vs_cpu(dev):
    """13(d): the DSEC model on the card and on the CPU at DSEC_REDUCED.
    The forward under phase 4's tolerance model, and its metric sums
    (with_occ=False): the counts equal, each EPE sum within the mean |d| of
    the flows (a bound by the triangle inequality), each threshold count
    within the number of elements whose reference EPE lies no further from
    the threshold than their |d| (the only ones that can cross it). Then
    one l1 step with the sparse masks (MI off) under phase 7's bounds, the
    CPU replaying the card's discrete choices."""
    from rpeflow_tpu_torch.flagship import dsec_training_cfg, make_dsec_batch
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_
    from rpeflow_tpu_torch.train.evaluator import MODEL_KEYS, _metric_sums
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step

    init = seeded_init_(RPEFlow(model_cfg("l1"), REDUCED_SAMPLES), DSEC_SEED + 10)
    batch = make_dsec_batch(DSEC_SEED + 10, device="cpu", targets=True, **DSEC_REDUCED)
    runs = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        model = copy.deepcopy(init).to(device)
        tb = {k: t.to(device) for k, t in batch.items()}
        with torch.inference_mode():
            out = model({k: tb[k] for k in MODEL_KEYS})
            runs[name] = ({k: v.cpu().double() for k, v in out.items()},
                          {k: float(v) for k, v in _metric_sums(out, tb, False).items()})
    (out, sums), (ref, ref_sums) = runs["card"], runs["cpu"]
    bad, result = [], {}
    epe = {}
    for key, dim in (("flow_2d", 2), ("flow_3d", 3)):
        o, r = out[key], ref[key]
        d = (o - r).abs()
        frac = float((d <= 2e-2 + 1e-3 * r.abs()).double().mean())
        result[key] = {"within": frac, "mean_abs": float(d.mean()), "max_abs": float(d.max())}
        if not torch.isfinite(o).all() or frac < 0.995 or float(d.mean()) >= 2e-2:
            bad.append(key)
        target = batch[key].double()
        mask = target[..., dim] > 0
        epe[key] = (torch.linalg.norm(r - target[..., :dim], dim=-1)[mask],
                    torch.linalg.norm(o - r, dim=-1)[mask])
    for prefix, key, thresholds in (("2d", "flow_2d", {"1px": 1.0}),
                                    ("3d", "flow_3d", {"5cm": 0.05, "10cm": 0.1})):
        e_ref, shift = epe[key]
        if sums[f"{prefix}/counts"] != ref_sums[f"{prefix}/counts"]:
            bad.append(f"{prefix}/counts")
        gap = abs(sums[f"{prefix}/EPE{prefix}"] - ref_sums[f"{prefix}/EPE{prefix}"])
        if gap > float(shift.sum()) * (1 + 1e-5) + 1e-3:
            bad.append(f"{prefix}/EPE{prefix}")
        for name, thr in thresholds.items():
            near = int(((e_ref - thr).abs() <= shift + 1e-6).sum())
            if abs(sums[f"{prefix}/{name}"] - ref_sums[f"{prefix}/{name}"]) > near:
                bad.append(f"{prefix}/{name}")
    # Fl: EPE > 3 px and EPE > 5% of the target's magnitude
    e_ref, shift = epe["flow_2d"]
    mask = batch["flow_2d"][..., 2] > 0
    mag = torch.linalg.norm(batch["flow_2d"][..., :2].double(), dim=-1)[mask]
    near = int((((e_ref - 3.0).abs() <= shift + 1e-6)
                | ((e_ref - 0.05 * mag).abs() <= shift + 1e-6)).sum())
    if abs(sums["2d/Fl"] - ref_sums["2d/Fl"]) > near:
        bad.append("2d/Fl")
    result["metric_sums"] = {"card": sums, "cpu": ref_sums}
    print(f"  (d) DSEC forward card vs CPU at batch 1, {DSEC_REDUCED['h']}x{DSEC_REDUCED['w']}, "
          f"{DSEC_REDUCED['n']} points: {result}", flush=True)

    zero_grad = pre_norm_biases(init)
    tape, records = [], {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        model = copy.deepcopy(init).to(device).train()
        opt = optimizer_factory(dsec_training_cfg(), model, steps_per_epoch=100)
        with shared_choices(tape, replay=name == "cpu") as counts:
            summary = train_step(model, opt, {k: t.to(device) for k, t in batch.items()}, None,
                                 compute_mi=False)
        records[name] = step_record(model, summary)
    breaches, worst = step_breaches(records["card"], records["cpu"], zero_grad)
    breaches += [(f"replayed {k}", d, n) for k, (d, n) in counts.items()
                 if not 0 < n or d > REPLAY_BOUND[k] * n]
    result["step"] = {"loss": [records[k][0]["loss"] for k in ("card", "cpu")],
                      "worst_gradient_share": worst, "replayed": counts}
    print(f"  (d) DSEC l1 step card vs CPU (sparse 2-D masks, MI off): loss "
          f"{records['card'][0]['loss']:.6f} vs {records['cpu'][0]['loss']:.6f}; worst gradient "
          f"at {worst:.3f} of its bound; the CPU's own choices differing from the card's "
          f"(replayed): {counts}", flush=True)
    if bad or breaches:
        raise AssertionError(f"DSEC card vs CPU outside the bounds: forward {bad}, step "
                             f"{breaches[:8]}")
    return result


T0 = time.perf_counter()


def step_state(model, opt):
    """Every leaf a train step moves, by group (parameters, Adam's state,
    buffers), copied."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "adam": {f"{names[id(p)]}.{k}": v.detach().clone()
                     for p, st in opt.optimizer.state.items() for k, v in st.items()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


def worst_gaps(run, ref):
    """Per group of two runs' :func:`step_state` (and their summaries): the
    norm of the difference over the norm of ``ref`` over all the group's
    leaves, and the leaf with the largest ``max |a - b| / max |b|`` with
    that gap."""
    (sums, state), (ref_sums, ref_state) = run, ref
    out = {}
    for group, leaves in ref_state.items():
        gaps = {k: float((state[group][k].double() - v.double()).abs().max())
                / (float(v.double().abs().max()) or 1.0) for k, v in leaves.items() if v.numel()}
        diff = sum(float((state[group][k].double() - v.double()).square().sum())
                   for k, v in leaves.items())
        norm = (diff / sum(float(v.double().square().sum()) for v in leaves.values())) ** .5
        out[group] = (norm, *max(gaps.items(), key=lambda kv: kv[1]))
    a = torch.tensor([v for sm in sums for v in sm.values()], dtype=torch.float64)
    b = torch.tensor([v for sm in ref_sums for v in sm.values()], dtype=torch.float64)
    gaps = {f"{i}.{k}": abs(x[k] - y[k]) / (abs(y[k]) or 1.0)
            for i, (x, y) in enumerate(zip(sums, ref_sums)) for k in y}
    out["summaries"] = (float((a - b).norm() / b.norm()),
                        *max(gaps.items(), key=lambda kv: kv[1]))
    return out


def eager_spread(eager, graphed):
    """Per group (:func:`worst_gaps`'s): the largest gap between two of the
    ``eager`` runs' ``(summaries, step_state)`` and the smallest between
    ``graphed`` and one of them. A graphed run that computes what an eager
    one computes is one more draw of the eager runs' rounding noise (the
    backward's atomic sums differ from run to run), so it lies no farther
    from its nearest eager run than two eager runs lie apart, within a
    factor for the draw."""
    pairs = [worst_gaps(a, b) for i, a in enumerate(eager) for b in eager[i + 1:]]
    near = [worst_gaps(graphed, e) for e in eager]
    return {g: (max(p[g][0] for p in pairs), min(n[g][0] for n in near)) for g in near[0]}


def graph_vs_eager(dev, label, model, training, batches):
    """14: ``batches`` through three eager runs and one graphed run of
    ``model``'s copies, each with a fresh optimizer and MI generator: ms a
    step, the step counter, the launches of each step and, per group, the
    graphed run's gap to its nearest eager run held to twice the eager
    runs' largest (:func:`eager_spread`), with the leaf of the largest gap
    to the first eager run."""
    from rpeflow_tpu_torch.ops import _cuda
    from rpeflow_tpu_torch.train import graph
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import eager_train_step, train_step

    runs = []
    for step in (eager_train_step,) * 3 + (train_step,):
        copy_ = copy.deepcopy(model)
        opt = optimizer_factory(training, copy_, steps_per_epoch=100)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        graph.reset_step_counts()
        sums, ms, launches = [], [], []
        for bt in batches:
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            sums.append(step(copy_, opt, bt, gen))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(_cuda.LAUNCHES))
        runs.append(((sums, step_state(copy_, opt)), ms, launches, dict(graph.STEPS)))
        del copy_, opt
        torch.cuda.empty_cache()
    eager, graphed = runs[:3], runs[3]
    spread = eager_spread([r[0] for r in eager], graphed[0])
    leaf = worst_gaps(graphed[0], eager[0][0])
    steps = {k: n for k, n in graphed[3].items() if n}
    print(f"  {label}: eager ms/step {[round(t, 1) for t in eager[0][1]]}, graphed "
          f"{[round(t, 1) for t in graphed[1]]} (first sight, capture + replay, replays); "
          f"steps {steps}", flush=True)
    for group, (tol, got) in spread.items():
        print(f"  {label}: {group}: graphed vs nearest eager {got:.3e}, eager vs eager up to "
              f"{tol:.3e}; largest leaf gap to the first eager run {leaf[group][2]:.3e} "
              f"({leaf[group][1]})", flush=True)
    bad = [g for g, (tol, got) in spread.items() if got > 2 * tol]
    if steps != {"eager_first_sight": 1, "capture": 1, "replay": len(batches) - 2}:
        bad.append(f"steps {steps}")
    if any(n != eager[0][2][0] for n in graphed[2]):
        bad.append(f"launches {graphed[2]} against {eager[0][2][0]}")
    if bad:
        raise AssertionError(f"{label}: graphed steps outside the eager runs' spread: {bad}")
    return {"eager_ms": eager[0][1], "graphed_ms": graphed[1], "steps": steps,
            "gaps": {g: got for g, (_, got) in spread.items()},
            "eager_gaps": {g: tol for g, (tol, _) in spread.items()},
            "leaf_gaps": {g: leaf[g][1:] for g in leaf}}


def phase_step_graph(dev):
    """14: the train step as a CUDA graph against eager steps at the FT3D
    training shape (pretrain.yaml's model and Adam) and the DSEC fine-tune
    shape (dsec.yaml's), MI on, 4 steps each (:func:`graph_vs_eager`)."""
    from rpeflow_tpu_torch.flagship import DSEC_TRAIN, dsec_training_cfg, make_dsec_batch
    from rpeflow_tpu_torch.model import RPEFlow, seeded_init_

    report = {}
    for label, order, training, make, shape in (
            ("FT3D", "l2", training_cfg(), make_batch, TRAIN),
            ("DSEC", "l1", dsec_training_cfg(), make_dsec_batch, DSEC_TRAIN)):
        torch.cuda.empty_cache()
        model = seeded_init_(RPEFlow(model_cfg(order), N_SAMPLES), SEED).to(dev).train()
        batches = [make(SEED + 40 + i, device=dev, targets=True, **shape) for i in range(4)]
        report[label] = graph_vs_eager(dev, label, model, training, batches)
        del model, batches
    print(json.dumps({"step_graph": report}), flush=True)


def phase(title):
    print(f"{title} (at {time.perf_counter() - T0:.0f} s)", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = timing.card_line(dev)
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from rpeflow_tpu_torch.ops import _cuda
    from rpeflow_tpu_torch.train.precision import use_f32

    use_f32()

    t0 = time.perf_counter()
    _cuda.lib()
    print(f"[2] build: {time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_info['seconds']:.1f} s)")
    for line in _cuda.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("   ", line.strip())

    phase("[3] kernels vs plain PyTorch (TF32 off; median of 20 timed runs)")
    kernel_results = phase_kernels(dev)
    phase("[4] card vs CPU, whole slice at batch 1, 128x192, 2048 points")
    phase_card_vs_cpu(dev)
    phase("[5] flagship forward, batch 4, 576x960, 8192 + 8192 points")
    eval_launches = phase_flagship(dev)
    phase("[6] autograd functions on the card vs torch.autograd of the plain versions")
    phase_autograd(dev)
    phase("[7] train step, card vs CPU, batch 1, 128x192, 2048 points, MI off")
    phase_train_card_vs_cpu(dev)
    phase("[8] flagship training, pretrain.yaml model, 540x960, 8192 + 8192 points, MI on")
    train_launches, phase8 = phase_train_flagship(dev)
    phase("[9] data parallelism: (a) one-rank NCCL group and (b) two gloo ranks vs one process, "
          "batch 2, 128x192, 2048 points, MI on")
    phase_dp_reduced(dev)
    phase("[9] (c) flagship training in a one-rank NCCL group")
    phase_dp_flagship(dev, phase8)
    phase("[10] amp: bf16 in the two 2-D pyramids, card vs CPU at 128x192, flagship training")
    phase_amp(dev)
    phase("[11] tools: gathers, zero store and the repro graph, native voxelizers, profile, "
          "train-step tool, KNN-1 and convex benches, resample study")
    tool_results, tool_launches, _ = phase_tools(dev)
    phase("[12] the bench (python -m rpeflow_tpu_torch.bench --workload all), twice, each in a "
          "fresh process")
    phase_bench()
    phase("[13] DSEC: eval forward (batch 3, 480x640, 8192 + 8192 points) and fine-tune step "
          "(l1, MI on; batch 3, then 12), each kernel at the DSEC shapes, card vs CPU at 144x192")
    phase_dsec(dev)
    phase("[14] the train step as a CUDA graph against eager steps, FT3D (batch 4, 540x960) "
          "and DSEC (batch 3, 480x640), MI on")
    phase_step_graph(dev)

    kernels = []
    for name, (src, rep) in SOURCES.items():
        r = kernel_results[name]
        path_launches = eval_launches if name in EXPECTED["eval forward"] else train_launches
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": path_launches[name], "launches_train_step": train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": max(r["bound"], key=r["bound"].get),
            "share": r["bound_ms"] / r["ms"], "library_ms": r["library_ms"]})
    for name, (src, rep, tool) in TOOL_SOURCES.items():
        r = tool_results[name]
        path = "gather tool" if name.startswith("gather") else "repro tool"
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "path": tool,
            "launches": tool_launches[path][name], "launches_train_step": train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": max(r["bound"], key=r["bound"].get),
            "share": r["bound_ms"] / r["ms"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"], "host_us": r["host_us"],
            "library_device_ms": r["library_device_ms"], "library_host_us": r["library_host_us"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
