"""Occlusion-aware evaluation (counterpart of eval_withocc.py).

    python -m rpeflow_tpu_torch.eval_withocc --config conf/test/things.yaml --weights best.pt

Runs on the first CUDA device, or on the CPU with ``--device cpu``, or over
N GPUs with ``torchrun --nproc_per_node=N -m ...`` in place of ``python -m``
(each rank evaluates its slice of every batch); prints the metrics as one
JSON line at the end.
"""

import json

from rpeflow_tpu_torch.train.evaluator import main

if __name__ == "__main__":
    metrics = main(None, with_occ=True, default_config="conf/test/things.yaml")
    if metrics is not None:  # rank 0 of a torchrun group reports
        print(json.dumps(metrics))
