"""Training on one device (counterpart of train.py).

    python -m rpeflow_tpu_torch.train --config conf/train/pretrain.yaml [--device cpu]
"""

from rpeflow_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
