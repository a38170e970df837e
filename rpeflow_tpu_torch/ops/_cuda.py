"""Build, load and count the hand-written Hopper kernels.

The CUDA C++ sources in ``rpeflow_tpu_torch/csrc/`` are compiled with
``nvcc`` (one process per source, all started together, then one link)
into a shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, into ``build/torch_kernels/<hash>``
under the repository root (listed in ``.gitignore``), keyed by a hash of the
sources, the headers and the flags, so a fresh checkout builds them itself
and an unchanged tree reuses the library. Nothing here runs at import time:
this module is imported on machines with no ``nvcc`` and no card, where only
the plain PyTorch versions run.

Each kernel wrapper counts its launches in :data:`LAUNCHES` (one per wrapper
call that launches its kernel, never for a CPU tensor), so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
#: source -> {``__global__`` function: the :data:`LAUNCHES` key of the wrapper
#: that launches it}, the one list of the hand-written kernels
SOURCES = {
    "fps.cu": {"fps_kernel": "fps"},
    "correlation.cu": {"corr_fwd": "correlation2d", "corr_bwd": "correlation2d_bwd"},
    "mdta.cu": {"mdta_kernel": "mdta_qkv", "sum_partials": "mdta_qkv"},
    "gdfn.cu": {"gdfn_kernel": "gdfn"},
    "dwconv.cu": {"dw_fwd_kernel": "dwconv", "dw_bwd_kernel": "dwconv",
                  "sum_partials_kernel": "dwconv"},
    "gather.cu": {"gather_rows_kernel": "gather_rows", "gather_lanes_staged_kernel": "gather_lanes",
                  "gather_lanes_l2_kernel": "gather_lanes"},
    "zero_store.cu": {"zero_store_kernel": "zero_store"},
    "conv3x3.cu": {"conv3x3_fwd_kernel": "conv3x3"},
}
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel wrapper; see :func:`reset_launch_counts`.
LAUNCHES = {key: 0 for kernels in SOURCES.values() for key in kernels.values()}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # name: (argtypes, restype)
    "rpeflow_fps": ((_P, _I, _I, _I, _P, _P), _I),
    "rpeflow_correlation2d": ((_P, _P, _P, _P, _P), _I),
    "rpeflow_correlation2d_bwd": ((_P, _P, _P, _P, _P, _P, _P), _I),
    "rpeflow_mdta_smem_bytes": ((_I, _I, _I, _I), ctypes.c_longlong),
    "rpeflow_mdta_qkv": ((_P, _P, _P, _P, _P, _P, _P, _P, _P, _P), _I),
    "rpeflow_gdfn": ((_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "rpeflow_gdfn_tile_rows": ((_I, _I, _I, _I), _I),
    "rpeflow_dwconv": ((_P, _P, _P, _P, _P), _I),
    "rpeflow_dwconv_bwd": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _P), _I),
    "rpeflow_gather_rows": ((_P, _P, _P, _L, _L, _L, _L, _I, _P), _I),
    "rpeflow_gather_lanes": ((_P, _P, _P, _L, _L, _L, _L, _I, _I, _I, _I, _I, _P), _I),
    "rpeflow_zero_store": ((_P, _L, _P), _I),
    "rpeflow_conv3x3": ((_P, _P, _P, _P, _P, _P), _I),
    "rpeflow_conv3x3_smem_bytes": ((_I, _I, _I), ctypes.c_longlong),
    "rpeflow_conv3x3_blocks_per_sm": ((_I, _I, _I), _I),
}

_lib = None
build_info: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


def _digest() -> str:
    """Build key: the flags, the sources and every header under ``CSRC``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if this tree's sources have not been built.

    Returns the path of the shared library. Records the build's seconds and
    the compiler's register/shared-memory report in :data:`build_info`.
    """
    out_dir = BUILD_ROOT / _digest()
    so = out_dir / "librpeflow_torch_kernels.so"
    if so.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("log", "(cached)")
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [out_dir / f"{Path(name).stem}.{os.getpid()}.o" for name in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [(name, proc.returncode, log) for name, proc, log in zip(SOURCES, procs, logs)
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    tmp = out_dir / f"lib.{os.getpid()}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, so)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = "".join(logs)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = handle
    return _lib


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device | int) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as an address
    (``torch.cuda.current_stream(device).cuda_stream`` without building a
    Stream object: a few microseconds less per kernel call)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


class on_device:  # noqa: N801 (used as a function: ``with on_device(dev) as stream``)
    """Make ``device`` the current device for a launch, and yield the address
    of its current stream. The CUDA runtime launches on the calling thread's
    current device, which need not be the one the operands are on (a rank on
    ``cuda:1`` that never set its device would launch on device 0). Where it
    already is the calling thread's current device, the device guard is
    skipped; a class, not a generator, since it runs at every launch."""

    __slots__ = ("device", "guard")

    def __init__(self, device: torch.device):
        self.device = device
        self.guard = (None if device.index == torch.cuda.current_device()
                      else torch.cuda.device(device))

    def __enter__(self) -> int:
        if self.guard is not None:
            self.guard.__enter__()
        return stream(self.device)

    def __exit__(self, *exc) -> None:
        if self.guard is not None:
            self.guard.__exit__(*exc)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def require_cuda(name: str, *tensors: torch.Tensor, dtype=torch.float32) -> None:
    """Validate kernel operands: one CUDA device, dtype, contiguity, no grad."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{name}: the raw kernel wrapper records no gradient; call the "
                "differentiable function of its module, or run under torch.no_grad()")
