"""rpeflow_tpu_torch: the PyTorch / CUDA port of rpeflow_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout (``ops``, ``nn``, ``model``, ``train``)
and its channels-last public functions, and imports ``torch`` only. The
kernels the JAX package wrote in Pallas for the TPU are CUDA C++ for
``sm_90a`` under ``csrc/``, built at first use (``ops/_cuda.py``); every
kernel wrapper runs its plain PyTorch version for CPU tensors.

This release covers the evaluation forward (``model.RPEFlow``,
``train.evaluator``, the ``eval_withocc`` / ``eval_noocc`` CLIs).
"""

__version__ = "0.1.0"
