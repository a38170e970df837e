"""FLOPs of one iteration of a workload, from its shapes alone (copied from
``rpeflow_tpu_torch/utils/flops.py``; the benchmark applies it to its frozen
reference, so the count does not change when the program changes what
implements an operation).

Inside :class:`FlopCount` every product the iteration runs is counted:

* each convolution as 2 * Cin/groups * Cout * kh * kw * Hout * Wout * B,
  and in a backward each of its input and weight gradients asked for as
  much again (the bias gradient is a sum, not counted);
* each ``mm``, ``bmm``, ``addmm`` and ``baddbmm`` as 2 * M * N * K, which
  takes in every ``linear``, ``matmul`` and ``einsum`` (each is one of
  these) and so the KNN searches' distance products, in a backward their
  gradients' products too;
* each call of a function the program runs as a hand-written kernel
  (:func:`counted`) by its formula, :func:`~benchmark.lib.work.kernel_flops`,
  in place of the plain products that run inside it.

No elementwise work is counted (activations, norms, softmax, additions,
reductions). The count is of the products the iteration runs, so work that
a backward recomputes (the activation checkpoints' blocks, the MDTA and
GDFN backwards' compositions) counts again. The aten products come from
``torch.utils.flop_counter.FlopCounterMode``, its grouped-convolution
gradient replaced by the formula above (PyTorch's counts a grouped conv's
weight gradient ``groups`` times).
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from .work import kernel_flops

_ACTIVE: FlopCount | None = None


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None, **_kwargs):
    """Each gradient asked for (input, weight) costs the forward's FLOPs:
    2 * B * prod(w) over the forward's output positions (its input's for a
    transposed conv)."""
    positions = math.prod((x_shape if transposed else grad_out_shape)[2:])
    forward = 2 * x_shape[0] * math.prod(w_shape) * positions
    return forward * (int(output_mask[0]) + int(output_mask[1]))


class FlopCount:
    """Context manager: :attr:`total` is the FLOPs run inside it (the
    module docstring says what counts); :attr:`kernels` the kernel wrappers'
    part by name; :attr:`calls` each kernel wrapper call's name and shape,
    in call order (the benchmark's per-layer readings take each call's least
    time from them)."""

    def __init__(self):
        self.mode = FlopCounterMode(
            display=False,
            custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flop})
        self.kernels: dict[str, float] = {}
        self.calls: list[tuple[str, tuple]] = []
        self._inside = 0      # depth of kernel wrapper calls
        self._excluded = 0    # aten FLOPs run inside kernel wrapper calls

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("FlopCount: a count is already active")
        self.mode.__enter__()
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return self.mode.__exit__(*exc)

    @property
    def total(self) -> float:
        return float(self.mode.get_total_flops() - self._excluded + sum(self.kernels.values()))

    def _kernel_call(self, name, shape, fn, args, kwargs):
        self.calls.append((name, tuple(shape)))
        if self._inside:  # a wrapper inside a wrapper: the outer one's formula covers it
            return fn(*args, **kwargs)
        before = self.mode.get_total_flops()
        self._inside += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._inside -= 1
        self._excluded += self.mode.get_total_flops() - before
        self.kernels[name] = self.kernels.get(name, 0.0) + kernel_flops(name, shape)
        return out


def counted(name: str, shape_of):
    """Decorator of a model kernel's wrapper: inside a :class:`FlopCount`, a
    call counts ``kernel_flops(name, shape_of(*args, **kwargs))`` and none
    of the aten products it runs; outside one, the wrapper runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            count = _ACTIVE
            if count is None:
                return fn(*args, **kwargs)
            return count._kernel_call(name, shape_of(*args, **kwargs), fn, args, kwargs)
        return wrapper
    return wrap
