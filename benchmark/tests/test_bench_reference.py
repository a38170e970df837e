"""The frozen reference (``benchmark/reference``) against the port on the
CPU, where the port runs its plain versions: at a tiny size (64x64 frames,
256 points, 2 decode levels, batch 2) the eval forward and its metric sums,
and three train steps (losses, gradients, parameters, running statistics)
agree; and the benchmark's FLOP count of the reference equals the port's
``utils/flops.py`` count of the port, with the same kernel calls."""

import pytest
import torch

from benchmark import check, harness
from benchmark.lib.flops import FlopCount
from benchmark.reference.train import Adam
from benchmark.reference.train import train_step as ref_step
from benchmark.tests.tiny_cells import CPU, SEED, tiny_cell
from rpeflow_tpu_torch.model import RPEFlow
from rpeflow_tpu_torch.train.evaluator import _metric_sums
from rpeflow_tpu_torch.train.optim import optimizer_factory
from rpeflow_tpu_torch.train.state import train_step
from rpeflow_tpu_torch.utils.flops import FlopCount as PortFlopCount

CELLS = ["ft3d_eval", "dsec_eval", "ft3d_train", "dsec_finetune"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def models(cell, train):
    sd = check.weights(cell, SEED, CPU)
    port = RPEFlow(cell.model_ns(), cell.config["n_samples"])
    port.load_state_dict(sd)
    return port.train(train), check.reference_model(cell, sd, CPU, train), sd


@pytest.mark.parametrize("name", ["ft3d_eval", "dsec_eval"])
def test_eval_forward_and_sums(name):
    cell = tiny_cell(name)
    port, ref, _ = models(cell, train=False)
    bt = check.batch(cell, SEED, 0, CPU)
    inputs = {k: bt[k] for k in check.MODEL_KEYS}
    with torch.no_grad():
        p, r = port(inputs), ref(inputs)
        ps, rs = _metric_sums(p, bt, cell.with_occ), check.metric_sums(r, bt, cell.with_occ)
    for k in ("flow_2d", "flow_3d"):
        torch.testing.assert_close(p[k], r[k], rtol=0, atol=0)
    assert list(ps) == list(rs) == list(check.sum_keys(cell.with_occ))
    for k in ps:
        torch.testing.assert_close(ps[k], rs[k], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["ft3d_train", "dsec_finetune"])
def test_train_steps(name):
    """Step 1 agrees to the bit in the gradients and to Adam's rounding in
    the parameters; three steps agree in the losses and in each leaf's
    change and running statistics as the check compares them."""
    cell = tiny_cell(name)
    port, ref, sd = models(cell, train=True)
    training = cell.config["training"]
    opt = optimizer_factory(harness.namespace(training), port, 1000)
    ref_opt = Adam(ref, training["lr"]["init_value"], training["weight_decay"],
                   training["bias_decay"])
    gens = [torch.Generator().manual_seed(7) for _ in range(2)]
    port_losses, ref_losses = [], []
    for i in range(3):
        bt = check.batch(cell, SEED, i, CPU)
        port_losses.append(train_step(port, opt, bt, gens[0])["loss"])
        ref_loss, used = ref_step(ref, ref_opt, bt, gens[1])
        ref_losses.append(ref_loss)
        if i == 0:
            ref_first = {n: g.clone() for n, g in used.items()}
            for (n, a), (m, b) in zip(port.named_parameters(), ref.named_parameters()):
                assert n == m
                if a.grad is not None:
                    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
                torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    # elementwise the parameters part after step 1: an element whose gradient
    # is near nought changes sign on rounding, and Adam moves it by up to
    # 2 lr the other way; each leaf's change, as the check takes it, agrees
    numbers = check.train_numbers(
        check.state_readings(port, ref_first, port_losses, sd),
        check.state_readings(ref, ref_first, ref_losses, sd))
    assert numbers["loss.gap"] < 1e-6 and numbers["change.gap"] < 1e-3, numbers
    assert numbers["bn.gap"] < 1e-3, numbers


@pytest.mark.parametrize("name", CELLS)
def test_flop_count_equals_the_ports(name):
    cell = tiny_cell(name)
    port, ref, _ = models(cell, train=cell.train)
    bt = check.batch(cell, SEED, 0, CPU)
    counts = []
    for model, counter in ((port, PortFlopCount), (ref, FlopCount)):
        with counter() as count:
            if cell.train:
                _, aux = model(bt, compute_mi=True, compute_loss=True,
                               generator=torch.Generator().manual_seed(7))
                aux["loss"].backward()
            else:
                with torch.no_grad():
                    model({k: bt[k] for k in check.MODEL_KEYS})
        counts.append(count)
    port_count, ref_count = counts
    assert ref_count.total == port_count.total > 0
    assert ref_count.kernels == port_count.kernels
    assert ref_count.calls == port_count.calls
