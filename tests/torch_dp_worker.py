"""Rank bodies of the port's data-parallel tests (tests/test_torch_parallel*.py).

Each runs in a process started by ``rpeflow_tpu_torch.parallel.dryrun.
spawn_ranks``, joins the gloo group from torchrun's environment, and writes
what the test compares to ``<out>/rank<r>.pt``. They import torch and the
port only.
"""

import os

import torch

from chip_smoke import shared_choices
from rpeflow_tpu_torch.parallel import mesh
from rpeflow_tpu_torch.parallel.mesh import maybe_initialize_distributed


def _join(threads: int = 2) -> int:
    torch.set_num_threads(threads)
    assert maybe_initialize_distributed("cpu")
    return mesh.process_index()


def _save(out: str, rank: int, result) -> None:
    result["collectives"] = dict(mesh.COLLECTIVES)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def all_reduce_and_batch_norm(spec_path: str, out: str) -> None:
    """``all_reduce_sum`` on a rank's rows, then ``batch_norm`` in training
    mode on the rank's slice of a global batch, each with a backward."""
    from rpeflow_tpu_torch.nn.layers import batch_norm

    rank = _join()
    spec = torch.load(spec_path)
    x = spec["x"][rank].clone().requires_grad_()
    y = mesh.all_reduce_sum(x, "test")
    (y * spec["w"][rank]).sum().backward()
    result = {"sum": y.detach(), "sum_grad": x.grad}

    bn = torch.nn.BatchNorm2d(spec["bn_weight"].shape[0])
    with torch.no_grad():
        bn.weight.copy_(spec["bn_weight"])
        bn.bias.copy_(spec["bn_bias"])
    n = spec["images"].shape[0] // mesh.process_count()
    rows = slice(rank * n, (rank + 1) * n)
    xb = spec["images"][rows].clone().requires_grad_()
    out_bn = batch_norm(bn.train(), xb)
    (out_bn * spec["g"][rows]).sum().backward()
    result.update(bn_out=out_bn.detach(), bn_input_grad=xb.grad, bn_weight_grad=bn.weight.grad,
                  bn_bias_grad=bn.bias.grad, running_mean=bn.running_mean,
                  running_var=bn.running_var)
    _save(out, rank, result)


def train_step(spec_path: str, out: str) -> None:
    """One ``train.state.train_step`` on the rank's slice of the spec's
    batch, recording its discrete choices (``chip_smoke.shared_choices``)
    and which of them the forward made."""
    from rpeflow_tpu_torch.model import RPEFlow
    from rpeflow_tpu_torch.train.config import ConfigNode
    from rpeflow_tpu_torch.train.optim import optimizer_factory
    from rpeflow_tpu_torch.train.state import train_step as step

    rank = _join()
    spec = torch.load(spec_path)
    model = RPEFlow(ConfigNode(spec["cfg"]), spec["n_samples"])
    model.load_state_dict(spec["state"])
    model.train()
    mesh.replicate(model)
    opt = optimizer_factory(ConfigNode(spec["training"]), model, steps_per_epoch=10)
    tape, span = [], []
    forward = model.forward

    def recorded_forward(*args, **kwargs):
        span.append(len(tape))
        outputs = forward(*args, **kwargs)
        span.append(len(tape))
        return outputs

    model.forward = recorded_forward
    with shared_choices(tape, replay=False):
        summary = step(model, opt, mesh.shard_batch(spec["batch"]),
                       torch.Generator().manual_seed(spec["seed"]), compute_mi=spec["mi"])
    _save(out, rank, {
        "summary": summary, "tape": tape, "forward_span": span,
        "params": {k: p.detach() for k, p in model.named_parameters()},
        "grads": {k: p.grad for k, p in model.named_parameters() if p.grad is not None},
        "buffers": dict(model.named_buffers())})


def evaluate(cfg_path: str, out: str) -> None:
    """The evaluator's totals over the rank's slices of the test set."""
    from rpeflow_tpu_torch.train.config import load_config
    from rpeflow_tpu_torch.train.evaluator import Evaluator

    rank = _join()
    evaluator = Evaluator(load_config(cfg_path), with_occ=True, device="cpu")
    totals, times = {}, []
    evaluator._run_round(totals, times)
    _save(out, rank, {"totals": totals, "n_timed": len(times)})


def trainer(cfg_path: str, out: str) -> None:
    """``python -m rpeflow_tpu_torch.train --device cpu`` as one rank of a
    torchrun group."""
    from rpeflow_tpu_torch.train.trainer import main

    torch.set_num_threads(2)
    main(["--config", cfg_path, "--device", "cpu"])
    _save(out, mesh.process_index(), {})
