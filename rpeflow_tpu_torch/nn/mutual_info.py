"""Mutual-information regulariser heads (counterpart of
rpeflow_tpu/nn/mutual_info.py): parameters only.

The heads only feed the training loss, so the evaluation forward never calls
them; they exist so that a training checkpoint loads with ``strict=True``.
Their forward belongs to the training slice.
"""

from __future__ import annotations

import torch.nn as nn

from .layers import ConvNormAct


class MutualInfoReg(nn.Module):
    """``{rgb,point[,event]}_{mu,logvar}`` 1x1 ConvNormActs, no activation."""

    def __init__(self, in_channels: int, hidden_channels: int, n_modalities: int,
                 n_spatial: int):
        super().__init__()
        for prefix in ("rgb", "point", "event")[:n_modalities]:
            for part in ("mu", "logvar"):
                self.add_module(f"{prefix}_{part}", ConvNormAct(
                    in_channels, hidden_channels, activation=None, n_spatial=n_spatial))

    def forward(self, *feats):
        raise NotImplementedError("training slice")
