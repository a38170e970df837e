"""Evaluation without the occlusion split (counterpart of eval_noocc.py).

    python -m rpeflow_tpu_torch.eval_noocc --config conf/test/dsec.yaml --weights best.pt

Runs on the first CUDA device, or on the CPU with ``--device cpu``; prints
the metrics as one JSON line at the end.
"""

import json

from rpeflow_tpu_torch.train.evaluator import main

if __name__ == "__main__":
    print(json.dumps(main(None, with_occ=False, default_config="conf/test/dsec.yaml")))
