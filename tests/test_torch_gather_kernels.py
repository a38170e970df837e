"""The port's gathers and zero store against the Pallas kernels they replace.

``ops.gather.gather_rows_plain`` / ``gather_lanes_plain`` are held to
``scripts/bench_gather.py : pallas_rows``, ``pallas_rowloop`` and
``pallas_lanes``, and ``ops.zero_store.zero_store_plain`` to
``triage/repro_xla_custom_call.py : pallas_zero``, each Pallas kernel run
under ``pltpu.force_tpu_interpret_mode()`` on the same seeded numpy inputs.
The gather script reads its shapes from module globals at call time, so
``B, N, C, M, TILE_M`` are patched small. Equality is exact: both sides copy
values. On the CPU the wrappers (``gather_rows``, ``gather_lanes``,
``zero_store``) take the plain versions and count no launch; the kernels
themselves are held to the plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 11).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rpeflow_tpu_torch.ops import _cuda, gather, zero_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(B=2, N=64, C=8, M=128, TILE_M=32)


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        "jax_" + os.path.basename(rel)[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench_gather():
    return _load("scripts/bench_gather.py")


@pytest.fixture(scope="module")
def repro():
    return _load("triage/repro_xla_custom_call.py")


@pytest.fixture
def small(bench_gather, monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(bench_gather, name, value)
    return bench_gather


def _inputs(seed, b=SMALL["B"], n=SMALL["N"], c=SMALL["C"], m=SMALL["M"]):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, n, c).astype(np.float32),
            rng.randint(0, n, size=(b, m)).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kernel", ["pallas_rows", "pallas_rowloop"])
def test_gather_rows_plain_equals_pallas(small, kernel, seed):
    table, idx = _inputs(seed)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(small, kernel)(jnp.asarray(table), jnp.asarray(idx)))
    got = gather.gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.take_along_axis(table, idx[..., None], axis=1))


@pytest.mark.parametrize("seed", [0, 1])
def test_gather_lanes_plain_equals_pallas(small, seed):
    table, idx = _inputs(seed)
    table_cf = np.ascontiguousarray(table.transpose(0, 2, 1))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(small.pallas_lanes(jnp.asarray(table_cf), jnp.asarray(idx)))
    got = gather.gather_lanes_plain(torch.from_numpy(table_cf), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,dtype,idx_dtype", [
    (5, torch.float32, np.int32), (5, torch.float32, np.int64), (5, torch.bfloat16, np.int32),
    (5, torch.bfloat16, np.int64), (8, torch.bfloat16, np.int64)], ids=str)
def test_gather_lanes_plain_equals_pallas_groups_and_types(bench_gather, monkeypatch, c, dtype,
                                                           idx_dtype):
    """``pallas_lanes`` at a channel count that is no multiple of the
    kernel's channel group (C = 5), with a bfloat16 table and with int64
    indices (JAX, 64-bit types off, takes them as int32; the port as they
    are), against the plain version and the CPU wrapper."""
    for name, value in dict(SMALL, C=c).items():
        monkeypatch.setattr(bench_gather, name, value)
    table, idx = _inputs(4, c=c)
    table_cf = np.ascontiguousarray(table.transpose(0, 2, 1))
    idx = idx.astype(idx_dtype)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(bench_gather.pallas_lanes(jnp.asarray(table_cf, dtype=jdtype),
                                                    jnp.asarray(idx)))
    t = torch.from_numpy(table_cf).to(dtype)
    i = torch.from_numpy(idx)
    _cuda.reset_launch_counts()
    for got in (gather.gather_lanes_plain(t, i), gather.gather_lanes(t, i)):
        assert got.dtype == dtype and got.shape == (SMALL["B"], c, SMALL["M"])
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    assert _cuda.LAUNCHES["gather_lanes"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_cpu_wrappers_take_the_plain_gathers(dtype, idx_dtype):
    """Any C, both table and index types, repeated indices and the ends:
    the wrappers equal plain indexing on the CPU and launch nothing."""
    rng = np.random.RandomState(3)
    b, n, m, c = 2, 9, 31, 3
    table = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(np.concatenate([rng.randint(0, n, (b, m - 4)),
                                           np.array([[0, n - 1, n - 1, 0]] * b)], 1))
    idx = idx.to(idx_dtype)
    _cuda.reset_launch_counts()
    rows = gather.gather_rows(table, idx)
    lanes = gather.gather_lanes(table.transpose(1, 2).contiguous(), idx)
    ref = torch.stack([table[i][idx[i].long()] for i in range(b)])
    assert rows.dtype == dtype and torch.equal(rows, ref)
    assert torch.equal(lanes, ref.transpose(1, 2))
    assert _cuda.LAUNCHES["gather_rows"] == _cuda.LAUNCHES["gather_lanes"] == 0


@pytest.mark.parametrize("shape,tile_h", [((2, 16, 8, 4), 8), ((1, 8, 3, 5), 8),
                                          ((2, 24, 6, 16), 4), ((2, 16, 8, 4), 16),
                                          ((3, 24, 6, 16), 8), ((3, 8, 5, 3), 8)])
def test_zero_store_plain_equals_pallas(repro, shape, tile_h):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(repro.pallas_zero(jnp.asarray(x), tile_h))
    _cuda.reset_launch_counts()
    got = zero_store.zero_store(torch.from_numpy(x), tile_h)
    assert got.dtype == torch.float32 and _cuda.LAUNCHES["zero_store"] == 0
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(zero_store.zero_store_plain(torch.from_numpy(x), tile_h).numpy(),
                                  want)


@pytest.mark.parametrize("fn", [zero_store.zero_store, zero_store.zero_store_plain])
def test_zero_store_refuses_a_ragged_tail(fn):
    """The Pallas grid (B, H // th) leaves rows past (H // th) * th unwritten:
    the port raises instead of matching an undefined tail."""
    with pytest.raises(ValueError, match="not a multiple"):
        fn(torch.zeros(1, 15, 4, 2), 8)
