"""What TF32 would do to the port's eval forward: a measurement, not a knob.

    python scripts/torch_tf32_measure.py

On the first CUDA device, runs ``chip_smoke.py``'s phase 4 (the whole slice
on the card against the CPU at batch 1, 128x192, 2048 points, under the
tolerance model of ``tests/test_wrapper_parity.py``) and phase 5 (the
flagship eval forward, ms per batch of 4) twice: in float32 as the port's
drivers run (``train.precision.use_f32``), then with
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` both True. Phase 4 under TF32 may fall
outside the tolerance model: its agreement is printed, and the run goes on.
The package itself always runs in float32.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from rpeflow_tpu_torch.train.precision import use_f32  # noqa: E402


def set_tf32(on: bool) -> None:
    if on:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    else:
        use_f32()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_tf32_measure needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda:0")
    for tf32 in (False, True):
        set_tf32(tf32)
        name = "TF32 on" if tf32 else "float32 (TF32 off)"
        print(f"== {name}: phase 4, card vs CPU", flush=True)
        try:
            chip_smoke.phase_card_vs_cpu(dev)
            print(f"== {name}: within the tolerance model", flush=True)
        except AssertionError as err:
            print(f"== {name}: outside the tolerance model: {err}", flush=True)
        print(f"== {name}: phase 5, flagship forward", flush=True)
        chip_smoke.phase_flagship(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
