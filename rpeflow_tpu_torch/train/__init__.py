"""Evaluation loop (counterpart of rpeflow_tpu.train; training is not ported yet)."""
