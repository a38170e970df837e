"""Evaluation without the occlusion split (counterpart of eval_noocc.py).

    python -m rpeflow_tpu_torch.eval_noocc --config conf/test/dsec.yaml --weights best.pt

Runs on the first CUDA device, or on the CPU with ``--device cpu``, or over
N GPUs with ``torchrun --nproc_per_node=N -m ...`` in place of ``python -m``
(each rank evaluates its slice of every batch); prints the metrics as one
JSON line at the end.
"""

import json

from rpeflow_tpu_torch.train.evaluator import main

if __name__ == "__main__":
    metrics = main(None, with_occ=False, default_config="conf/test/dsec.yaml")
    if metrics is not None:  # rank 0 of a torchrun group reports
        print(json.dumps(metrics))
