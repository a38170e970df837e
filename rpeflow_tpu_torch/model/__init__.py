"""Model assembly: the RPEFlow evaluation forward (counterpart of rpeflow_tpu.model)."""

from .core import RPEFlowCore
from .rpeflow import DEFAULT_N_SAMPLES, RPEFlow, flow_metrics, seeded_init_

__all__ = ["DEFAULT_N_SAMPLES", "RPEFlow", "RPEFlowCore", "flow_metrics", "seeded_init_"]
