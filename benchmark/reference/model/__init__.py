"""Model assembly: the RPEFlow forward, losses and metrics."""

from .core import RPEFlowCore
from .rpeflow import DEFAULT_N_SAMPLES, RPEFlow, flow_metrics

__all__ = ["DEFAULT_N_SAMPLES", "RPEFlow", "RPEFlowCore", "flow_metrics"]
