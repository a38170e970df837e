"""The port's native event scatter (``rpeflow_tpu_torch/csrc/host_ops.cpp``
through ``rpeflow_tpu_torch/data/native.py``) against its numpy version and
against the JAX package's native library.

On seeded events (a random stream, an empty one, times that land exactly
on a bin, events in the last bin, at x = W - 1 and y = H - 1, and many
events in one cell), both voxelizers are held:

* native against plain (``events_to_voxel_plain``,
  ``events_to_voxel_trilinear_plain``) within atol 1e-6 and rtol 1e-6: the
  native scatter rounds each weight to float32 before it adds it, where
  numpy adds float64 weights (``events_to_voxel``) or computes the trilinear
  products in float64, so a cell that sums many events (the repeated and
  edge cases put 80 into one, |value| ~ 19) differs by a float32 step of
  its value, 1.9e-6 there; below |value| = 1 the bound is atol 1e-6;
* native against the JAX package's ``rpeflow_tpu.data`` voxelizers bit for
  bit where the JAX library loads (the same arithmetic, the same g++
  flags), else within atol 1e-6 of its numpy path.

An event whose pixel lies outside the grid raises ``IndexError``, as
``np.add.at`` does past the edge, and nothing is written outside the grid.

The build: a compiler that cannot be found raises, a source that does not
compile raises with the compiler's output, the build key changes with the
CPU fingerprint, and threads that build at once get one library.
"""

import threading

import numpy as np
import pytest

from rpeflow_tpu.data import dsec as jax_dsec
from rpeflow_tpu.data import event_voxel as jax_event_voxel
from rpeflow_tpu.data import native as jax_native
from rpeflow_tpu_torch.data import dsec, event_voxel, native

H, W, BINS = 24, 32, 5
CASES = ["random", "empty", "integer_t", "last_bin", "edges", "repeated"]


def _stream(case, seed=0):
    """x, y (float, in [0, W) x [0, H)), t (sorted), p in {0, 1}."""
    rng = np.random.RandomState(seed)
    n = 0 if case == "empty" else 2000
    x, y = rng.rand(n) * W, rng.rand(n) * H
    t = np.sort(rng.rand(n))
    p = rng.randint(0, 2, n).astype(np.float64)
    if n and case == "integer_t":  # every 4th event exactly on a bin of (BINS - 1)
        t[::4] = np.round(t[::4] * (BINS - 1)) / (BINS - 1)
        t = np.sort(t)
        t[0], t[-1] = 0.0, 1.0
    elif n and case == "last_bin":  # a quarter of the stream at the last time
        t[-n // 4:] = t[-1]
    elif n and case == "edges":
        x[::3], y[1::3] = W - 1, H - 1
        x[2::7], y[2::7] = W - 1 + 0.5 * rng.rand(len(x[2::7])), H - 1
    elif n and case == "repeated":
        x[: n // 2], y[: n // 2] = 7.25, 3.5
    return x, y, t, p


def _integer_events(case):
    x, y, t, p = _stream(case)
    return np.stack([np.floor(x), np.floor(y), t * 1e5, p], 1).astype(np.float32)


def _check_jax(got, want, jax_native_loaded):
    if jax_native_loaded:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_loaded():
    return jax_native._load() is not None


@pytest.mark.parametrize("polarity", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_event_voxel_native_plain_and_jax(case, polarity, jax_loaded):
    events = _integer_events(case)
    got = event_voxel.events_to_voxel(events, BINS, H, W, polarity)
    plain = event_voxel.events_to_voxel_plain(events, BINS, H, W, polarity)
    assert got.shape == (H, W, BINS * (2 if polarity else 1)) and got.dtype == np.float32
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    _check_jax(got, jax_event_voxel.events_to_voxel(events, BINS, H, W, polarity), jax_loaded)
    if case != "empty":
        assert np.abs(got).sum() > 0


@pytest.mark.parametrize("case", CASES)
def test_trilinear_native_plain_and_jax(case, jax_loaded):
    x, y, t, p = _stream(case)
    xs, ys, ts, ps = (a.astype(np.float32) for a in (x, y, t, p))
    got = dsec.events_to_voxel_trilinear(xs, ys, ts, ps, BINS, H, W)
    plain = dsec.events_to_voxel_trilinear_plain(xs, ys, ts, ps, BINS, H, W)
    assert got.shape == (BINS, H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    _check_jax(got, jax_dsec.events_to_voxel_trilinear(xs, ys, ts, ps, BINS, H, W), jax_loaded)


def test_scatter_skips_bins_outside_the_grid():
    vox = np.zeros((BINS, H, W), np.float32)
    native.event_scatter_add(vox, [1, 2, 3], [0, 1, 2], [-1, BINS, BINS - 1], [5.0, 6.0, 7.0])
    assert vox.sum() == 7.0 and vox[BINS - 1, 2, 3] == 7.0
    with pytest.raises(ValueError, match="float32"):
        native.event_scatter_add(vox.astype(np.float64), [0], [0], [0], [1.0])


@pytest.mark.parametrize("x, y, t", [(W, H - 1, BINS - 1), (0, H, BINS - 1), (-1, 0, 0),
                                     (0, -1, 0)])
def test_scatter_raises_on_pixels_outside_the_grid(x, y, t):
    """An event outside ``[0, W) x [0, H)`` raises and is never written: the
    grid sits between two guard slabs that stay zero."""
    guarded = np.zeros((BINS + 2, H, W), np.float32)
    with pytest.raises(IndexError, match="1 events lie outside"):
        native.event_scatter_add(guarded[1:-1], [3, x], [2, y], [1, t], [0.5, 9.0])
    assert not guarded[0].any() and not guarded[-1].any()
    assert guarded[1:-1].sum() == 0.5


def test_voxelizer_raises_on_events_past_the_edge():
    events = _integer_events("random")
    events[5, 0] = W
    with pytest.raises(IndexError):
        event_voxel.events_to_voxel_plain(events, BINS, H, W)
    with pytest.raises(IndexError):
        event_voxel.events_to_voxel(events, BINS, H, W)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The module as before its first use, building under ``tmp_path``."""
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "torch_host")
    monkeypatch.setattr(native, "_LIB", None)
    return tmp_path


def test_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-rpeflow")
    with pytest.raises(RuntimeError, match="no-such-compiler-rpeflow"):
        native.lib()
    with pytest.raises(RuntimeError):
        dsec.events_to_voxel_trilinear(*(np.ones(3, np.float32),) * 4, BINS, H, W)


def test_failed_build_raises_with_the_compiler_output(fresh_build, monkeypatch):
    broken = fresh_build / "host_ops.cpp"
    broken.write_text("extern \"C\" void event_scatter_add( { }\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="error"):
        native.lib()


def test_build_key_follows_the_cpu(tmp_path, monkeypatch):
    keys = []
    for flags in ("fpu sse2 avx2 fma", "fpu sse2"):
        cpuinfo = tmp_path / f"cpuinfo-{len(keys)}"
        cpuinfo.write_text(f"model name\t: Some CPU\nflags\t\t: {flags}\n")
        monkeypatch.setattr(native, "CPUINFO", str(cpuinfo))
        keys.append((native.host_fingerprint(), native.build_key()))
    assert keys[0][0] != keys[1][0] and keys[0][1] != keys[1][1]


def test_concurrent_first_builds_make_one_library(fresh_build):
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(set(paths)) == 1 and paths[0].exists()
    built = sorted(p.name for p in paths[0].parent.iterdir())
    assert built == ["librpeflow_torch_host.so", "lock"], built
    vox = np.zeros((BINS, H, W), np.float32)
    native.event_scatter_add(vox, [1], [2], [3], [0.5])
    assert vox[3, 2, 1] == 0.5
