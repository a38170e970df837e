"""Weight bridge from the JAX package.

The port's modules carry the upstream torch ``state_dict`` names, so a JAX
variable tree exported by ``rpeflow_tpu.compat.torch_loader.to_torch_state_dict``
(numpy only) loads directly, as does an upstream ``.pt`` checkpoint
(:func:`load_checkpoint`).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn as nn


def load_jax_variables(model: nn.Module, variables: Mapping[str, Any], strict: bool = True):
    """Load a JAX ``{'params', 'batch_stats'}`` tree into ``model``.

    ``variables`` holds numpy arrays (or anything ``np.asarray`` takes). The
    RPEFlow model's tree maps onto this package's ``RPEFlow``; a submodule's
    tree (e.g. one ``CrossTransformerBlock``'s) onto its counterpart.
    Returns ``load_state_dict``'s result.
    """
    from rpeflow_tpu.compat.torch_loader import to_torch_state_dict

    state = {k: torch.from_numpy(np.array(v)) for k, v in to_torch_state_dict(variables).items()}
    return model.load_state_dict(state, strict=strict)


def load_checkpoint(model: nn.Module, path: str, strict: bool = True):
    """Load an upstream-format ``.pt`` file: a bare state_dict or
    ``{'state_dict': ...}``, with any DDP ``module.`` prefix stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt)
    state = {k[len("module."):] if k.startswith("module.") else k: v for k, v in state.items()}
    return model.load_state_dict(state, strict=strict)
