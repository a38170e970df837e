"""Training and evaluation drivers (counterpart of rpeflow_tpu.train): the
optimizer and schedules, checkpoints, the train/eval steps, the trainer
(``python -m rpeflow_tpu_torch.train``) and the evaluator."""
