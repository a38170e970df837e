"""Low-level ops (counterpart of rpeflow_tpu.ops), channels-last.

``fps``, ``correlation``, ``mdta``, ``gdfn``, ``dwconv`` and ``conv3x3``
(the 2-D decoder's 3x3 convs) wrap the hand-written CUDA kernels of the
model, ``gather`` (``gather_rows``, ``gather_lanes``) and ``zero_store``
those of the tools; the rest is plain PyTorch. (``gdfn`` is not
re-exported: the name stays the submodule's.)
"""

from .correlation import correlation2d, correlation2d_plain
from .fps import furthest_point_sampling, furthest_point_sampling_plain
from .gather import batch_gather, batch_gather_xyz_feat
from .geometry import (
    CameraInfo,
    parallel2perspect,
    perspect2parallel,
    project_feat_with_nn_corr,
    project_pc2image,
)
from .interp import (
    backwarp_3d,
    convex_upsample,
    knn_interpolation,
    resize_bilinear_ac,
    resize_flow2d,
    resize_to_64x,
)
from .knn import k_nearest_neighbor, squared_distance
from .mdta import mdta_qkv, mdta_qkv_plain
from .sample import backwarp_2d, grid_sample_2d, mesh_grid

__all__ = [
    "CameraInfo",
    "backwarp_2d",
    "backwarp_3d",
    "batch_gather",
    "batch_gather_xyz_feat",
    "convex_upsample",
    "correlation2d",
    "correlation2d_plain",
    "furthest_point_sampling",
    "furthest_point_sampling_plain",
    "grid_sample_2d",
    "k_nearest_neighbor",
    "knn_interpolation",
    "mdta_qkv",
    "mdta_qkv_plain",
    "mesh_grid",
    "parallel2perspect",
    "perspect2parallel",
    "project_feat_with_nn_corr",
    "project_pc2image",
    "resize_bilinear_ac",
    "resize_flow2d",
    "resize_to_64x",
    "squared_distance",
]
