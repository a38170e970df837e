"""A run with the timed path broken underneath comes out not correct.

The harness runs each cell at a tiny size on the CPU (its look for a card
is in ``benchmark/run.py`` and is skipped here), with the cell's own
limits, once sound and once for each fault the cell can have: half of the
batch left out (eval: the answers of the first half stand for all; train:
the step's mean over the rest), an answer altered where it is produced
(eval: the last frame pair gets the first pair's flows, or its metric sums
are taken of them; train: one leaf's gradient doubled on its way to the
optimizer), and, for a train cell, a
step that returns its state unchanged. The exchange between chips does not
exist in a one-chip cell."""

import pytest
import torch

from benchmark import check, harness
from benchmark.tests.tiny_cells import run, tiny_cell

LEAF = "pwc_fusion_core.flow_estimator_2d.conv1.conv_fn.weight"


class HalfBatch(harness.Program):
    def __call__(self, batch):
        b = batch["pcs"].shape[0]
        keep = max(1, b // 2)
        if self.cell.train:
            return super().__call__({k: t[:keep] for k, t in batch.items()})
        with torch.inference_mode():
            flows = self.model({k: batch[k][:keep] for k in check.MODEL_KEYS})
            flows = {k: f.repeat(-(-b // keep), *[1] * (f.dim() - 1))[:b]
                     for k, f in flows.items()}
            sums = self._sums(flows, batch, self.cell.with_occ)
            return flows, torch.stack([sums[k] for k in self.keys]).tolist()


class AlteredAnswer(harness.Program):
    def __init__(self, *args):
        super().__init__(*args)
        if self.cell.train:
            dict(self.model.named_parameters())[LEAF].register_hook(lambda g: 2 * g)

    def __call__(self, batch):
        if self.cell.train:
            return super().__call__(batch)
        with torch.inference_mode():
            flows = self.model({k: batch[k] for k in check.MODEL_KEYS})
            flows = {k: torch.cat([f[:-1], f[:1]]) for k, f in flows.items()}
            sums = self._sums(flows, batch, self.cell.with_occ)
            return flows, torch.stack([sums[k] for k in self.keys]).tolist()


class AlteredSums(harness.Program):
    """The flows as produced, their metric sums taken with the last frame
    pair's flows replaced by the first pair's (eval only)."""

    def __call__(self, batch):
        with torch.inference_mode():
            flows = self.model({k: batch[k] for k in check.MODEL_KEYS})
            altered = {k: torch.cat([f[:-1], f[:1]]) for k, f in flows.items()}
            sums = self._sums(altered, batch, self.cell.with_occ)
            return flows, torch.stack([sums[k] for k in self.keys]).tolist()


class StateUnchanged(harness.Program):
    def __call__(self, batch):
        state = {k: v.clone() for k, v in self.model.state_dict().items()}
        out = super().__call__(batch)
        self.model.load_state_dict(state)
        return out


CASES = [(cell, fault) for cell in ("ft3d_eval", "dsec_eval")
         for fault in (harness.Program, HalfBatch, AlteredAnswer, AlteredSums)] + \
        [(cell, fault) for cell in ("ft3d_train", "dsec_finetune")
         for fault in (harness.Program, HalfBatch, AlteredAnswer, StateUnchanged)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell,fault", CASES, ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault):
    result = run(tiny_cell(cell), make_program=fault, seconds=0.2)
    sound = fault is harness.Program
    assert result["correct"] is sound, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
