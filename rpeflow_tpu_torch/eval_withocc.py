"""Occlusion-aware evaluation (counterpart of eval_withocc.py).

    python -m rpeflow_tpu_torch.eval_withocc --config conf/test/things.yaml --weights best.pt

Runs on the first CUDA device, or on the CPU with ``--device cpu``; prints
the metrics as one JSON line at the end.
"""

import json

from rpeflow_tpu_torch.train.evaluator import main

if __name__ == "__main__":
    print(json.dumps(main(None, with_occ=True, default_config="conf/test/things.yaml")))
