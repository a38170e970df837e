"""The control comes out not correct: the reference computed in TF32, the
nearest precision below the configuration's float32, put in the program's
place, at each cell's own size on the card, is held to the float32
reference by the cell's limits and fails at least one of them.

On the card: ``python3 -m pytest -m cuda benchmark/tests/test_bench_control.py``.
"""

import pytest
import torch

from benchmark import check, harness

SEED = 2**31 + 101


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in harness.load_spec()["workloads"]])
def test_control_is_not_correct(card, name):
    cell = harness.load_cell(name)
    warm = cell.traffic["warmup"]
    if cell.train:
        reference, _ = check.reference_train(cell, SEED, card, steps=warm)
        with check.tf32(True):
            control, _ = check.reference_train(cell, SEED, card, steps=warm)
        numbers = check.train_numbers(control, reference)
    else:
        idx = list(range(warm, warm + cell.traffic["sample"]))
        with check.tf32(True):
            control, _ = check.reference_eval(cell, SEED, idx, card)
        # judged as a run judges the program: the metric sums against the
        # reference's sums of the control's own flows
        reference, _ = check.reference_eval(cell, SEED, idx, card,
                                            judged=[f for f, _ in control])
        numbers = check.eval_numbers(control, reference, check.sum_keys(cell.with_occ))
    correct, checks = check.judge(numbers, cell.limits)
    assert not correct, checks
