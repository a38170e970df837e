"""The benchmark's plain reference: a frozen copy of the plain PyTorch path of
``rpeflow_tpu_torch`` (the model, its blocks, the plain versions of the
hand-written kernels' functions, the losses and MI, the train step with Adam
written out, the evaluator's metric sums), for one process.

It imports nothing of the program. It takes the benchmark's seeded weights
as a state dict under the upstream names, the benchmark's batches and an
identically seeded MI generator, so on the same inputs it computes what the
program should. Each function the program runs as a hand-written kernel is
a :func:`benchmark.lib.flops.counted` function here, so a
:class:`~benchmark.lib.flops.FlopCount` over a reference iteration gives the
iteration's FLOPs and every kernel call with its shape.
"""
