"""rpeflow_tpu_torch: the PyTorch / CUDA port of rpeflow_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout (``ops``, ``nn``, ``model``, ``train``)
and its channels-last public functions, and imports ``torch`` only. The
kernels the JAX package wrote in Pallas for the TPU are CUDA C++ for
``sm_90a`` under ``csrc/``, built at first use (``ops/_cuda.py``); every
kernel wrapper runs its plain PyTorch version for CPU tensors.

It covers evaluation (``model.RPEFlow``, ``train.evaluator``, the
``eval_withocc`` / ``eval_noocc`` CLIs), training with autograd through the
kernels (``train.trainer``, ``python -m rpeflow_tpu_torch.train``), data
parallelism over ``torch.distributed`` under torchrun (``parallel``) and
its own host layer (``data``, ``train.config``, ``train.factory``). The
drivers compute in float32 with TF32 off (``train.precision.use_f32``), as
the JAX package does; ``amp: true`` runs the two 2-D feature pyramids in
bfloat16.
"""

__version__ = "0.1.0"
