"""Build, load and count the hand-written Hopper kernels.

The CUDA C++ sources in ``rpeflow_tpu_torch/csrc/`` are compiled with
``nvcc`` (one process per source, all started together, then one link)
into a shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, into ``build/torch_kernels/<hash>``
under the repository root (listed in ``.gitignore``), keyed by a hash of the
sources and flags, so a fresh checkout builds them itself and an unchanged
tree reuses the library. Nothing here runs at import time: this module is
imported on machines with no ``nvcc`` and no card, where only the plain
PyTorch versions run.

Each kernel wrapper counts its launches in :data:`LAUNCHES` (one per wrapper
call that launches its kernel, never for a CPU tensor), so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("fps.cu", "correlation.cu", "mdta.cu", "gdfn.cu", "dwconv.cu")
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel wrapper; see :func:`reset_launch_counts`.
LAUNCHES = {"fps": 0, "correlation2d": 0, "mdta_qkv": 0, "gdfn": 0, "dwconv": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (argtypes, restype)
    "rpeflow_fps": ((_P, _I, _I, _I, _P, _P), _I),
    "rpeflow_correlation2d": ((_P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "rpeflow_mdta_gram_chunks": ((ctypes.c_longlong,), _I),
    "rpeflow_mdta_qkv": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "rpeflow_gdfn": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "rpeflow_dwconv": ((_P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
    "rpeflow_dwconv_taps_blocks": ((_I, _I, _I, _I), _I),
    "rpeflow_dwconv_taps_grad": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _P), _I),
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
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


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


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
