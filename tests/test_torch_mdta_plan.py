"""The MDTA kernel's tile and grid plan (``rpeflow_tpu_torch/ops/mdta.py :
mdta_plan``), checked on the CPU at the 30 shapes of one flagship eval
forward and at the edge shapes the kernel is held to on the card: every
token in exactly one tile, shared memory within one block's 232,448 bytes,
and the scratch exactly the per-block partials. Also: the kernel library's
build key covers the headers under ``csrc/``."""

import shutil

import numpy as np
import pytest

from rpeflow_tpu_torch.ops import _cuda, mdta
from torch_port_utils import MDTA_EDGE_SHAPES, MDTA_FLAGSHIP_SHAPES

SHAPES = sorted(set(MDTA_FLAGSHIP_SHAPES + MDTA_EDGE_SHAPES))


@pytest.mark.parametrize("shape", SHAPES)
def test_every_token_in_exactly_one_tile(shape):
    plan = mdta.mdta_plan(*shape)
    b, h, w, c, kh = shape
    assert plan.th * plan.tw % 8 == 0 and plan.tw % plan.seg == 0
    assert (plan.th == 1) if kh == 1 else (plan.th == 8)
    assert 1 <= plan.nblk <= plan.tiles
    count = np.zeros((h, w), np.int64)
    for blk in range(plan.nblk):
        tiles = plan.block_tiles(blk)
        assert len(tiles) > 0, f"block {blk} has no tile"
        for t in tiles:
            y0, x0 = plan.tile_origin(t)
            assert 0 <= y0 < h and 0 <= x0 < w
            count[y0:y0 + plan.th, x0:x0 + plan.tw] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_shared_memory_and_scratch(shape):
    plan = mdta.mdta_plan(*shape)
    b, h, w, c, kh = shape
    assert plan.cp >= c and plan.cp % 32 == 0 and plan.cp % plan.ns == 0
    assert plan.smem_bytes <= mdta.SMEM_PER_BLOCK
    if plan.cp == 96:  # 512 threads: the second warp group's Gram sums pass through the halos
        assert 2 * plan.halo_tokens >= plan.ns
    # the partial of block (batch, slice, blk) starts at
    # ((batch * slices + slice) * nblk + blk) * partial_floats
    starts = sorted(((bi * plan.slices + s) * plan.nblk + blk) * plan.partial_floats
                    for bi in range(b) for s in range(plan.slices) for blk in range(plan.nblk))
    assert starts == list(range(0, plan.scratch_floats, plan.partial_floats))
    assert plan.partial_floats == plan.cp * plan.ns + 2 * plan.ns


@pytest.mark.parametrize("c,kh", [(c, kh) for c in (32, 64, 96, 128, 192, 256) for kh in (1, 3)])
def test_every_width_class_fits(c, kh):
    """The default tile of every width class fits one block, and the card
    holds the planned blocks at once (two per SM up to CP = 96)."""
    plan = mdta.mdta_plan(8, 144, 240, c, kh)
    assert plan.smem_bytes <= mdta.SMEM_PER_BLOCK
    per_sm = mdta.BLOCKS_PER_SM[plan.cp]
    assert per_sm * (plan.smem_bytes + 1024) <= mdta.SMEM_PER_SM
    assert plan.b * plan.slices * plan.nblk <= per_sm * 132  # all resident at once


@pytest.mark.parametrize("b,c", [(8, 32), (8, 96), (8, 192), (300, 192), (1000, 32)])
def test_blocks_fill_the_card_once(b, c):
    """nblk x slices x B blocks: as many as the card holds at once, or one
    per batch element and slice where the batch alone is more."""
    plan = mdta.mdta_plan(b, 144, 240, c, 3)
    resident = min(mdta.BLOCKS_PER_SM[plan.cp], mdta.SMEM_PER_SM // (plan.smem_bytes + 1024)) * 132
    blocks = plan.nblk * plan.slices * b
    assert blocks <= resident or plan.nblk == 1
    assert blocks > resident - b * plan.slices or plan.nblk == plan.tiles


def test_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError):
        mdta.mdta_plan(1, 8, 8, 257, 3)
    with pytest.raises(ValueError):
        mdta.mdta_plan(1, 8, 8, 32, 5)


def test_build_key_covers_headers(tmp_path, monkeypatch):
    for name in _cuda.SOURCES:
        shutil.copy(_cuda.CSRC / name, tmp_path / name)
    (tmp_path / "helpers.cuh").write_text("// v1\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    key = _cuda._digest()
    assert _cuda._digest() == key
    (tmp_path / "helpers.cuh").write_text("// v2\n")
    edited = _cuda._digest()
    assert edited != key
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _cuda._digest() not in (key, edited)
