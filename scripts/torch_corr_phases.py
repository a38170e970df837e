"""Where the correlation kernels' time goes: each phase compiled out in turn.

    python scripts/torch_corr_phases.py

A probe of ``rpeflow_tpu_torch/csrc/correlation.cu`` as it stands: it guards
the kernels' phases with ``#ifndef`` by finding literal fragments of their
code, and stops with an error where a fragment is gone. Builds variants into
``build/corr_phases/`` with nvcc (``-I`` to ``csrc/`` for the shared header):
``full``; ``no_stage`` without the shared-memory stages' copies (f1 and f2,
or the backward's F); ``no_compute`` without the products; ``no_store``
without the forward's row stores or the backward's gradient stores;
``no_a`` without the backward's A tile; ``none`` without all of them
(barriers, index arithmetic and the forward's output staging only). Each
variant's output is wrong by design: this measures time, not results.
Prints, on the first CUDA device, the device ms of one launch of each
variant (CUDA events around 20 launches back to back, median of 5) at the
two largest decode levels' shapes, d = 4, default plans.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from rpeflow_tpu_torch.ops import _cuda, correlation  # noqa: E402

SHAPES = ((4, 144, 240, 32), (4, 72, 120, 64))
D = 4


def _guard(src: str, start: str, end: str, macro: str, count: int = 1) -> str:
    """Wrap each of the first ``count`` runs of code from ``start`` to the
    regex ``end`` in ``#ifndef macro``."""
    pos = 0
    for _ in range(count):
        i = src.index(start, pos)
        j = re.compile(end).search(src, i).end()
        src = f"{src[:i]}\n#ifndef {macro}\n{src[i:j]}\n#endif\n{src[j:]}"
        pos = j + len(macro) + 20
    return src


def variant_source() -> str:
    src = (_cuda.CSRC / "correlation.cu").read_text()
    src = _guard(src, "stage<kVec>(smem, f1,", r"rows, cols\);", "NO_STAGE")
    src = _guard(src, "stage<kVec>(f_stage, f,", r"rows, cols\);", "NO_STAGE")
    src = _guard(src, "for (int s = 0; s < n4; ++s) {",
                 r"dot4\(acc\[j\]\[dx\], a\[j\], v\);\s*\}\s*\}\s*\}", "NO_COMPUTE")
    src = _guard(src, "#pragma unroll 1\n    for (int dy = 0; dy < kSide; ++dy) {",
                 r"acc\[j\]\.w\);\s*\}\s*\}\s*\}", "NO_COMPUTE")
    src = _guard(src, "for (int rr = 0; rr < th && y0 + rr < h; ++rr) {",
                 r"e < n; e \+= blockDim\.x\) out\[g0 \+ e\] = o\[e\];\s*\}", "NO_STORE")
    src = _guard(src, "if (y < h && ch < c) {", r"o\[i\] = vals\[i\];\s*\}\s*\}\s*\}",
                 "NO_STORE")
    src = _guard(src, "if (role == 0) {", r"cp_async_commit\(\);", "NO_A")
    return src


VARIANTS = {"full": [], "no_stage": ["-DNO_STAGE"], "no_compute": ["-DNO_COMPUTE"],
            "no_store": ["-DNO_STORE"], "no_a": ["-DNO_A"],
            "none": ["-DNO_STAGE", "-DNO_COMPUTE", "-DNO_STORE", "-DNO_A"]}


def build(out_dir) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "corr_variants.cu"
    src.write_text(variant_source())
    nvcc = _cuda._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *_cuda.NVCC_FLAGS, "-shared", "-I", str(_cuda.CSRC), *flags,
         "-o", str(out_dir / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn in ("rpeflow_correlation2d", "rpeflow_correlation2d_bwd"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = _cuda._SIGNATURES[fn]
        libs[name] = lib
    return libs


def launch_ms(fn, n=20, reps=5) -> float:
    """Device ms of one launch: events around ``n`` launches back to back."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[len(times) // 2]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_corr_phases needs a CUDA device", file=sys.stderr)
        return 1
    libs = build(_cuda.BUILD_ROOT.parent / "corr_phases")
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)
    print(torch.cuda.get_device_name(0))
    for shape in SHAPES:
        f1, f2 = (torch.randn(*shape, generator=g, device=dev) for _ in range(2))
        gout = torch.randn(*shape[:3], (2 * D + 1) ** 2, generator=g, device=dev)
        out, g1, g2 = torch.empty_like(gout), torch.empty_like(f1), torch.empty_like(f2)
        fp = correlation.correlation_plan(*shape, D)
        bp = correlation.correlation_plan(*shape, D, backward=True)
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib in libs.items():
            fwd = launch_ms(lambda: lib.rpeflow_correlation2d(
                f1.data_ptr(), f2.data_ptr(), out.data_ptr(), fp.c_plan[1], stream))
            bwd = launch_ms(lambda: lib.rpeflow_correlation2d_bwd(
                f1.data_ptr(), f2.data_ptr(), gout.data_ptr(), g1.data_ptr(), g2.data_ptr(),
                bp.c_plan[1], stream))
            print(f"correlation phases {shape} {name:10s}: forward {fwd:.4f} ms, "
                  f"backward {bwd:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
