"""Event-stream voxelization (host-side numpy).

Mirrors reference event_utils.py:109-128 / 211-303: timestamps normalized to
[0, B-1], temporal triangle (bilinear) weighting into B bins, integer-pixel
scatter accumulation; with ``event_polarity`` the positive (p>0) and negative
(p<=0) events land in separate B-bin grids concatenated positive-first.

Output is channels-LAST ``[H, W, B]`` / ``[H, W, 2B]`` (the reference emits
channel-first and transposes later; we are channels-last end to end).

The port's copy of ``rpeflow_tpu/data/event_voxel.py``. As in the JAX
package, the scatter runs in the native host library
(:mod:`.native`, ``csrc/host_ops.cpp``, built with g++ at first use); its
numpy body stays as :func:`_accumulate_plain` (:func:`events_to_voxel_plain`
scatters with it), which only tests and benches call. A failed build
raises: there is no silent numpy fallback.
"""

from __future__ import annotations

import numpy as np

from . import native


def load_events_h5(path: str) -> np.ndarray:
    """Load an event stream into ``[N, 4]`` float32 (x, y, t, p).

    Mirrors reference event_utils.py:11-20.
    """
    import h5py

    with h5py.File(path, "r") as f:
        n = len(f["x"])
        events = np.zeros([n, 4], dtype=np.float32)
        events[:, 0] = f["x"]
        events[:, 1] = f["y"]
        events[:, 2] = f["t"]
        events[:, 3] = f["p"]
    return events


def _accumulate(vox: np.ndarray, xs, ys, tis, weights, num_bins: int):
    """Scatter-add triangle-weighted events into the [B, H, W] grid, in the
    native library; a pixel outside the grid raises ``IndexError`` (as
    ``np.add.at`` does past the edge; it wraps negative ones)."""
    if vox.shape[0] != num_bins:
        raise ValueError(f"grid of {vox.shape[0]} bins for num_bins = {num_bins}")
    native.event_scatter_add(vox, xs, ys, tis, weights)


def _accumulate_plain(vox: np.ndarray, xs, ys, tis, weights, num_bins: int):
    """:func:`_accumulate` with ``np.add.at`` (the plain version)."""
    valid = tis < num_bins
    np.add.at(vox, (tis[valid], ys[valid], xs[valid]), weights[valid])


def events_to_voxel(
    events: np.ndarray,
    num_bins: int,
    height: int,
    width: int,
    event_polarity: bool = False,
) -> np.ndarray:
    """Voxelize an event stream. Returns ``[H, W, B]`` or ``[H, W, 2B]``."""
    return _events_to_voxel(events, num_bins, height, width, event_polarity, _accumulate)


def events_to_voxel_plain(events: np.ndarray, num_bins: int, height: int, width: int,
                          event_polarity: bool = False) -> np.ndarray:
    """:func:`events_to_voxel` scattering with :func:`_accumulate_plain`."""
    return _events_to_voxel(events, num_bins, height, width, event_polarity, _accumulate_plain)


def _events_to_voxel(events, num_bins, height, width, event_polarity, accumulate):
    if len(events) == 0:
        c = 2 * num_bins if event_polarity else num_bins
        return np.zeros([height, width, c], np.float32)

    xs = events[:, 0].astype(np.int32)
    ys = events[:, 1].astype(np.int32)
    ts = events[:, 2].astype(np.float64)
    ps = events[:, 3].astype(np.float32)

    t0, t1 = ts[0], ts[-1]
    denom = (t1 - t0) if t1 > t0 else 1.0
    t_norm = ((ts - t0) / denom * (num_bins - 1)).astype(np.float32)
    ti = np.floor(t_norm).astype(np.int32)
    frac = t_norm - ti

    def grid_for(weights):
        vox = np.zeros([num_bins, height, width], np.float32)
        accumulate(vox, xs, ys, ti, weights * (1.0 - frac), num_bins)
        accumulate(vox, xs, ys, ti + 1, weights * frac, num_bins)
        return vox

    if event_polarity:
        pos = grid_for((ps > 0).astype(np.float32))
        neg = grid_for((ps <= 0).astype(np.float32))
        vox = np.concatenate([pos, neg], axis=0)
    else:
        vox = grid_for(ps)
    return vox.transpose(1, 2, 0)  # [H, W, C]
