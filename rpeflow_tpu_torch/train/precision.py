"""The port's arithmetic on the card: full float32.

PyTorch runs float32 convolutions through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits. The JAX package computes in float32, and every tolerance the
port is held to assumes float32, so the drivers turn TF32 off for matrix
products and convolutions alike.
"""

import torch


def use_f32() -> None:
    """Run float32 matrix products and cuDNN convolutions in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
