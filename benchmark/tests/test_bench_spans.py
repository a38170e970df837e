"""The program's ``rpeflow.`` spans stay out of the benchmark's traces.

The benchmark's reader takes any named host span open at an idle gap for
the operator the host ran there, so a program span in its trace would
relabel the gaps of ``breakdown.idle_gaps``. The program records its spans
only where its own tracing turns them on
(``rpeflow_tpu_torch.utils.profile.record_spans``). A tiny cell's train
step and eval iteration, profiled on the CPU by the benchmark's own
capture, show no span; with the spans turned on, the same capture shows
them, so the check can see them.
"""

import pytest
import torch

from benchmark import check, harness
from benchmark.lib import profile
from benchmark.tests.tiny_cells import CPU, SEED, tiny_cell
from rpeflow_tpu_torch.utils.profile import SPAN, record_spans


def _span_names(name, spans_on):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    record_spans(spans_on)
    try:
        cell = tiny_cell(name)
        program = harness.Program(cell, check.weights(cell, SEED, CPU), SEED, CPU)
        batch = check.batch(cell, SEED, 0, CPU)
        events = profile.capture(program.model, program, [batch], lambda: None)
    finally:
        record_spans(False)
        torch.set_num_threads(threads)
    trace = profile.read(events)
    assert trace.iterations == 1
    return {e.name() for e in events if e.name().startswith(SPAN)}


@pytest.mark.parametrize("name,outer", [("ft3d_train", "rpeflow.train_step"),
                                        ("dsec_eval", "rpeflow.eval.metric_sums")])
def test_the_benchmark_trace_holds_no_program_span(name, outer):
    assert _span_names(name, False) == set()
    shown = _span_names(name, True)
    assert {outer, "rpeflow.forward", "rpeflow.forward.decode.level1"} <= shown
