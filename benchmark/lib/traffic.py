"""The one generator of the benchmark's inputs: batches of synthetic frame
pairs made on the device from a seed (the generators of
``rpeflow_tpu_torch/flagship.py : make_batch, make_dsec_batch``, copied and
moved onto the device; one function, the dataset's form read from the
configuration's ``data`` block).

A batch holds both RGB frames (uint8), the two point clouds (the first drawn
in the camera's frustum between 2 and 35 m, the second moved by a small
scene flow), the event voxel and the camera, and as targets the 2-D flow
with its validity channel, the 3-D flow with its validity channel and,
where the dataset has an occlusion split, the occlusion mask.
"""

from __future__ import annotations

import hashlib

import torch


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the part ``tag`` of a run with seed ``seed`` (any
    integer): the weights, the MI noise, each batch of the pool."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_batch(seed: int, shape: dict, data: dict, device, targets: bool = True) -> dict:
    """One batch of ``shape`` (``b``, ``h``, ``w``, ``n`` points,
    ``event_ch``) on ``device``, drawn from a generator there seeded with
    ``seed``. ``data`` is the configuration's data block: ``focal`` (px),
    ``flow_2d_valid`` (share of pixels with 2-D ground truth; 1 means dense),
    ``occluded`` (share of points occluded, 0 for a dataset with no
    occlusion split)."""
    b, h, w, n, ch = (shape[k] for k in ("b", "h", "w", "n", "event_ch"))
    f = float(data["focal"])
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*size):
        return torch.rand(size, generator=g, device=device)

    def randn(*size):
        return torch.randn(size, generator=g, device=device)

    cx, cy = (w - 1) / 2, (h - 1) / 2
    z = 2.0 + 33.0 * rand(b, n)
    u = rand(b, n) * (w - 1)
    v = rand(b, n) * (h - 1)
    pc1 = torch.stack([(u - cx) * z / f, (v - cy) * z / f, z], -1)
    flow3d = 0.1 * randn(b, n, 3)
    batch = {
        "images": torch.randint(0, 256, (b, h, w, 6), generator=g, dtype=torch.uint8,
                                device=device),
        "pcs": torch.cat([pc1, pc1 + flow3d], -1),
        "event_voxel": rand(b, h, w, ch),
        "intrinsics": torch.tensor([[f, cx, cy]], device=device).repeat(b, 1),
    }
    if not targets:
        return batch
    valid_2d = float(data["flow_2d_valid"])
    valid = (torch.ones(b, h, w, 1, device=device) if valid_2d >= 1.0
             else (rand(b, h, w, 1) < valid_2d).float())
    batch["flow_2d"] = torch.cat([4 * randn(b, h, w, 2), valid], -1)
    occluded = float(data["occluded"])
    if occluded > 0:
        batch["occ_mask_3d"] = (rand(b, n) < occluded).float()
        batch["flow_3d"] = torch.cat([flow3d, 1.0 - batch["occ_mask_3d"][..., None]], -1)
    else:
        batch["flow_3d"] = torch.cat([flow3d, torch.ones(b, n, 1, device=device)], -1)
    return batch
