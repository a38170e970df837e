"""Variational mutual-information regulariser heads (counterpart of
rpeflow_tpu/nn/mutual_info.py).

The heads only feed the training loss: their latents never reach the flow
features, so the model calls them only with ``compute_mi``. Numerics follow
the JAX package (and upstream):

* l2 normalisation with eps 1e-6 inside the sqrt;
* the KL's Normal has scale ``exp(logvar)``, the reparametrisation uses
  ``std = exp(logvar / 2)``;
* ``Independent(..., 1)`` sums the KL over torch's last axis (W of a
  ``[B, C, H, W]`` map, N of ``[B, C, N]`` points) and means over the rest.

The reparametrisation noise comes from :func:`draw_noise` with the
``torch.Generator`` the caller passes (tests replace the function to inject
the noise).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from .layers import ConvNormAct


def draw_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normal noise of ``shape`` on ``device`` from ``generator``."""
    return torch.randn(shape, generator=generator, device=device)


def _l2norm_feat(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-6)


def _bce(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch ``binary_cross_entropy`` (mean) with its -100 log clamp."""
    log_x = torch.clamp(torch.log(x), min=-100.0)
    log_1mx = torch.clamp(torch.log1p(-x), min=-100.0)
    return -(target * log_x + (1.0 - target) * log_1mx).mean()


def _kl_normal(mu1, lv1, mu2, lv2) -> torch.Tensor:
    """Elementwise KL(N(mu1, e^lv1) || N(mu2, e^lv2)); scales are exp(logvar)."""
    s1, s2 = torch.exp(lv1), torch.exp(lv2)
    return lv2 - lv1 + (s1 ** 2 + (mu1 - mu2) ** 2) / (2.0 * s2 ** 2) - 0.5


class MutualInfoReg(nn.Module):
    """``{rgb,point[,event]}_{mu,logvar}`` 1x1 ConvNormActs, no activation;
    pairwise (2 modalities) or three-way (3) variational MI loss."""

    def __init__(self, in_channels: int, hidden_channels: int, n_modalities: int,
                 n_spatial: int):
        super().__init__()
        self.prefixes = ("rgb", "point", "event")[:n_modalities]
        for prefix in self.prefixes:
            for part in ("mu", "logvar"):
                self.add_module(f"{prefix}_{part}", ConvNormAct(
                    in_channels, hidden_channels, activation=None, n_spatial=n_spatial))

    def forward(self, *feats: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``feats`` are ``[B, H, W, C]`` maps or ``[B, N, C]`` points, one
        per modality -> scalar loss."""
        if len(feats) != len(self.prefixes):
            raise ValueError(f"expected {len(self.prefixes)} modalities, got {len(feats)}")
        x0 = feats[0]
        torch_last = x0.shape[2] if x0.dim() == 4 else x0.shape[1]
        denom = x0.shape[1] * x0.shape[2] if x0.dim() == 4 else x0.shape[1]

        mus, lvs, zs = [], [], []
        for prefix, feat in zip(self.prefixes, feats):
            feat = _l2norm_feat(feat)
            mu = torch.tanh(getattr(self, f"{prefix}_mu")(feat).float())
            lv = torch.tanh(getattr(self, f"{prefix}_logvar")(feat).float())
            eps = draw_noise(mu.shape, generator, mu.device)
            mus.append(mu)
            lvs.append(lv)
            zs.append(torch.sigmoid(eps * torch.exp(0.5 * lv) + mu))

        ce = kld = 0.0
        pairs = [(0, 1)] if len(feats) == 2 else [(0, 1), (0, 2), (1, 2)]
        for i, j in pairs:
            ce = ce + _bce(zs[i], zs[j].detach()) + _bce(zs[j], zs[i].detach())
            kl_ij = _kl_normal(mus[i], lvs[i], mus[j], lvs[j]).sum()
            kl_ji = _kl_normal(mus[j], lvs[j], mus[i], lvs[i]).sum()
            kld = kld + (kl_ij + kl_ji) / (math.prod(mus[i].shape) / torch_last)
        return (ce - kld) / denom
