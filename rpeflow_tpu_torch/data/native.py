"""ctypes bindings of the native host-side event scatters
(``rpeflow_tpu_torch/csrc/host_ops.cpp``), the port's counterpart of
``rpeflow_tpu/data/native.py``.

The library is compiled with ``g++`` at first use into
``build/torch_host/<key>/`` under the repository root (listed in
``.gitignore``). ``<key>`` hashes the source, the flags and this host's CPU
(``-march=native`` emits the host's own instructions, and a checkout's
``build/`` may be copied to another machine, so a library built on one CPU
is never loaded on another). Concurrent first uses (pytest-xdist workers, the
process-pool ``DataLoader``) build under a file lock into a temporary name
that is then renamed. A missing compiler or a failed build or load raises,
with the compiler's output: unlike the JAX package, the port does not fall
back to numpy silently (the plain numpy versions are
``event_voxel._accumulate_plain`` and ``dsec.events_to_voxel_trilinear_plain``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_ops.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_host"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared")
CPUINFO = "/proc/cpuinfo"

_LIB = None
_LOCK = threading.Lock()

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    # name: (argtypes, restype)
    "event_scatter_add": ((_F, ctypes.c_int64, _I, _I, _I, _F, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_int32), ctypes.c_int64),
    "event_scatter_trilinear": ((_F, ctypes.c_int64, _F, _F, _F, _F, ctypes.c_int32,
                                 ctypes.c_int32, ctypes.c_int32), None),
}


def host_fingerprint() -> str:
    """The host's node, ISA, CPU model and flags, hashed."""
    parts = [platform.node(), platform.machine()]
    try:
        with open(CPUINFO) as f:
            parts += [line.strip() for line in f if line.startswith(("model name", "flags"))][:2]
    except OSError:
        pass
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def build_key() -> str:
    """Hash of the source, the flags and :func:`host_fingerprint`."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(host_fingerprint().encode())
    return h.hexdigest()[:16]


def compiler() -> str:
    """``$CXX``, else ``g++`` on the PATH; raises if there is none."""
    name = os.environ.get("CXX", "g++")
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"the native event scatter needs a C++ compiler: {name!r} not found "
                           "(set CXX)")
    return found


def build() -> Path:
    """Compile the library unless this source, these flags and this CPU have
    been built; returns its path."""
    out_dir = BUILD_ROOT / build_key()
    so = out_dir / "librpeflow_torch_host.so"
    if so.exists():
        return so
    cxx = compiler()
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if so.exists():  # built by another process while this one waited
                return so
            tmp = out_dir / f"lib.{os.getpid()}.{threading.get_ident()}.so"
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = handle
        return _LIB


def _grid(vox: np.ndarray) -> tuple[int, int, int]:
    if vox.ndim != 3 or vox.dtype != np.float32 or not vox.flags["C_CONTIGUOUS"]:
        raise ValueError(f"the native scatter writes a C-contiguous float32 [bins, H, W] grid, "
                         f"got {vox.dtype} {vox.shape}")
    return vox.shape


def event_scatter_add(vox: np.ndarray, xs, ys, tis, weights) -> None:
    """``vox[tis, ys, xs] += weights`` in place, events with ``tis`` outside
    ``[0, bins)`` skipped (``np.add.at`` of ``event_voxel._accumulate_plain``).
    Raises ``IndexError`` if an event of a valid bin lies outside the
    ``[H, W]`` grid (``x`` or ``y`` below 0 or past the edge); such events
    are never written."""
    b, h, w = _grid(vox)
    xs, ys, tis = (np.ascontiguousarray(a, np.int32) for a in (xs, ys, tis))
    weights = np.ascontiguousarray(weights, np.float32)
    outside = lib().event_scatter_add(vox.ctypes.data_as(_F), len(xs), xs.ctypes.data_as(_I),
                                      ys.ctypes.data_as(_I), tis.ctypes.data_as(_I),
                                      weights.ctypes.data_as(_F), b, h, w)
    if outside:
        raise IndexError(f"{outside} events lie outside the {h}x{w} grid "
                         "(x in [0, W) and y in [0, H) required)")


def event_scatter_trilinear(vox: np.ndarray, xs, ys, ts, values) -> None:
    """Each event ``values[i]`` spread over its 8 surrounding ``(t, y, x)``
    cells of ``vox`` with trilinear weights, in place; coordinates in float32."""
    b, h, w = _grid(vox)
    xs, ys, ts = (np.ascontiguousarray(a, np.float32) for a in (xs, ys, ts))
    values = np.ascontiguousarray(np.broadcast_to(np.asarray(values, np.float32), xs.shape))
    lib().event_scatter_trilinear(vox.ctypes.data_as(_F), len(xs), xs.ctypes.data_as(_F),
                                  ys.ctypes.data_as(_F), ts.ctypes.data_as(_F),
                                  values.ctypes.data_as(_F), b, h, w)
