"""The tools' kernels' plans and index arithmetic, on the CPU.

``ops.gather.lanes_plan`` picks the lane gather's branch (rows staged in
shared memory, or through the L2), its channel group, threads and splits of
M; the kernels of ``csrc/gather.cu`` and ``csrc/zero_store.cu`` compute
which block writes which outputs from it. The kernels run only on the card
(``tests/test_torch_kernels_cuda.py``), so their index arithmetic is written
out here in numpy and checked to write every output exactly once.
"""

import numpy as np
import pytest

from rpeflow_tpu_torch.ops import gather

LANE_SHAPES = [(4, 128, 8192, 131072, 4), (4, 128, 8192, 131072, 2), (4, 1, 8192, 2048, 4),
               (4, 5, 8192, 2048, 4), (3, 5, 8192, 2047, 2), (2, 3, 300, 2047, 2),
               (3, 128, 500, 1, 4), (2, 81, 1, 2047, 4), (2, 8, 65536, 2048, 4),
               (2, 5, 65536, 2047, 2), (1, 2, 58112, 9, 4), (1, 2, 58113, 9, 4)]


@pytest.mark.parametrize("b,c,n,m,itemsize", LANE_SHAPES, ids=str)
def test_lanes_plan(b, c, n, m, itemsize):
    """The L2 branch exactly where a row exceeds a block's 227 KB; else at
    most ``LANE_GROUP`` rows that fit a block, and splits of M that never
    leave a thread without four m nor push the blocks past what the SMs'
    shared memory holds at once (except one split)."""
    plan = gather.lanes_plan(b, c, n, m, itemsize, 132)
    row = n * itemsize
    assert (plan.g == 0) == (row > gather.BLOCK_SMEM)
    if plan.g == 0:
        return
    assert 1 <= plan.g <= min(c, gather.LANE_GROUP) and plan.g * row <= gather.BLOCK_SMEM
    assert plan.threads == gather.LANE_THREADS
    assert plan.splits == 1 or (plan.splits - 1) * 4 * plan.threads < m
    per_sm = min(gather.SM_SMEM // (plan.g * row + 1024), 2048 // plan.threads)
    assert plan.splits == 1 or b * -(-c // plan.g) * plan.splits <= 132 * per_sm
    if (b, c, n, m, itemsize) == (4, 128, 8192, 131072, 4):  # the gather tool's shape
        assert plan == gather.LanesPlan(2, 512, 1)


@pytest.mark.parametrize("b,c,n,m", [(0, 4, 8, 16), (2, 0, 8, 16), (2, 4, 0, 16),
                                     (2, 4, 8, 0)], ids=str)
def test_lanes_plan_of_an_empty_call(b, c, n, m):
    assert gather.lanes_plan(b, c, n, m, 4, 132) == gather.LanesPlan(0, 256, 1)


def staged_writes(b, c, m, plan, vec):
    """How many times the staged kernel writes each output [b, c, m]: block
    ``blockIdx.x = (b * groups + group) * splits + split`` as in
    ``gather_lanes_staged_kernel``."""
    count = np.zeros((b, c, m), np.int64)
    groups = -(-c // plan.g)
    chunk = (-(-m // plan.splits) + 3) // 4 * 4
    for blk in range(b * groups * plan.splits):
        split, bg = blk % plan.splits, blk // plan.splits
        bi, c0 = bg // groups, bg % groups * plan.g
        gc = min(plan.g, c - c0)
        m0, m1 = split * chunk, min(m, split * chunk + chunk)
        step = 4 if vec else 1
        for t in range(plan.threads):
            for q in range(m0 + step * t, m1, step * plan.threads):
                assert q + step <= m1  # a four-m step never runs past its range
                count[bi, c0:c0 + gc, q:q + step] += 1
    return count


@pytest.mark.parametrize("b,c,m,g,threads,splits", [
    (2, 5, 64, 4, 32, 1), (2, 5, 64, 2, 32, 3), (1, 3, 2048, 4, 64, 5), (3, 7, 28, 7, 32, 2),
    (1, 1, 4, 1, 32, 4)], ids=str)
@pytest.mark.parametrize("vec", [True, False])
def test_staged_lanes_write_every_output_once(b, c, m, g, threads, splits, vec):
    plan = gather.LanesPlan(g, threads, splits)
    np.testing.assert_array_equal(staged_writes(b, c, m, plan, vec), 1)


@pytest.mark.parametrize("m", [1, 2047, 2049])
def test_staged_lanes_scalar_walk_takes_any_m(m):
    plan = gather.lanes_plan(2, 5, 300, m, 4, 132)
    assert plan.g > 0
    np.testing.assert_array_equal(staged_writes(2, 5, m, gather.LanesPlan(plan.g, 32, 2),
                                                vec=False), 1)


def zero_writes(n, aligned=True, threads=256, per_thread=4):
    """How many times ``csrc/zero_store.cu`` writes each of ``n`` floats: a
    block per ``threads * per_thread`` units (16-byte words, or floats where
    the base is unaligned), thread t of block b storing units
    ``b * threads * per_thread + j * threads + t``; block 0 then stores the
    last ``n % 4`` floats of an aligned span one a thread."""
    count = np.zeros(n, np.int64)
    width = 4 if aligned else 1
    units = n // width
    per_block = threads * per_thread
    blocks = -(-units // per_block) if units > per_block else 1
    for blk in range(blocks):
        for j in range(per_thread):
            for t in range(threads):
                k = blk * per_block + j * threads + t
                if k < units:
                    count[width * k:width * k + width] += 1
    if aligned:
        tail = np.arange(n - units * 4)  # the threads of block 0 below n - words * 4
        count[units * 4 + tail] += 1
    return count


@pytest.mark.parametrize("n", [1, 3, 4, 1001, 4096, 4097, 40000, 798795])
@pytest.mark.parametrize("aligned", [True, False], ids=["vec4", "unaligned"])
def test_zero_store_writes_every_float_once(n, aligned):
    np.testing.assert_array_equal(zero_writes(n, aligned), 1)
