"""Model assembly: the RPEFlow forward, losses and metrics (counterpart of rpeflow_tpu.model)."""

from .core import RPEFlowCore
from .rpeflow import DEFAULT_N_SAMPLES, RPEFlow, flow_metrics, is_better, seeded_init_

__all__ = ["DEFAULT_N_SAMPLES", "RPEFlow", "RPEFlowCore", "flow_metrics", "is_better",
           "seeded_init_"]
