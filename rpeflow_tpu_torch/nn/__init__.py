"""PyTorch building blocks of the RPEFlow model (counterpart of rpeflow_tpu.nn)."""

from .layers import MLP, ConvNormAct
from .mdta import ChannelLayerNorm, CrossTransformerBlock, FeedForward, MutualAttention
from .mutual_info import MutualInfoReg
from .pointconv import PointConv
from .pyramid2d import (
    ContextNetwork2D,
    FeaturePyramid2D,
    FlowEstimator2D,
    ResidualBlock,
    UpMaskHead2D,
)
from .pyramid3d import Correlation3D, FeaturePyramid3D, FlowEstimator3D, build_pc_pyramid

__all__ = [
    "MLP",
    "ChannelLayerNorm",
    "ContextNetwork2D",
    "ConvNormAct",
    "Correlation3D",
    "CrossTransformerBlock",
    "FeaturePyramid2D",
    "FeaturePyramid3D",
    "FeedForward",
    "FlowEstimator2D",
    "FlowEstimator3D",
    "MutualAttention",
    "MutualInfoReg",
    "PointConv",
    "ResidualBlock",
    "UpMaskHead2D",
    "build_pc_pyramid",
]
