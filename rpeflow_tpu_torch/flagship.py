"""The flagship configurations and synthetic inputs of the port's runs on
the card (counterpart of ``__graft_entry__.py : _model_cfg`` and
``_synth_batch``), and DSEC's beside them.

``chip_smoke.py`` and the tools under ``scripts/torch_*.py`` read their
model, training block, shapes and batches from here, so every one of them
runs bit-identical configurations and batches. The configurations are built
in code (``SimpleNamespace``), not read from ``conf/``, so these runs need
neither a YAML file nor the ``yaml`` module.
"""

from __future__ import annotations

from types import SimpleNamespace as NS

import torch

#: the FlyingThings3D eval shape (conf/test/things.yaml: batch 4, 576x960,
#: a 20-channel event voxel, 8192 + 8192 points)
FLAGSHIP = dict(b=4, h=576, w=960, n=8192, event_ch=20)
#: points kept at each of the five decode levels
N_SAMPLES = (4096, 2048, 1024, 512, 256)
#: FT3D training frames (540x960, resized to 576x960 inside); batch 4 is the
#: per-GPU batch of the upstream recipe (16 over 4 GPUs)
TRAIN = dict(b=4, h=540, w=960, n=8192, event_ch=20)
#: the DSEC eval shape (conf/test/dsec.yaml: batch 3, 480x640 frames, resized
#: to 512x640 inside, a 20-channel event voxel, 8192 + 8192 points)
DSEC_EVAL = dict(b=3, h=480, w=640, n=8192, event_ch=20)
#: DSEC fine-tuning frames (conf/train/dsec.yaml); batch 3 is the per-GPU
#: batch of the upstream recipe (12 over 4 GPUs), as TRAIN's 4 is 16 over 4
DSEC_TRAIN = dict(b=3, h=480, w=640, n=8192, event_ch=20)
#: DSEC's rectified left camera at 640x480 (focal length in pixels)
DSEC_FOCAL = 569.0
#: share of pixels with 2-D ground truth in a synthetic DSEC batch
DSEC_VALID = 0.7


def model_cfg(order="l2"):
    """Model block of conf/test/things.yaml (the training losses of
    conf/train/pretrain.yaml added; the eval forward ignores them). With
    ``order="l1"`` it is the model block of conf/test/dsec.yaml and
    conf/train/{dsec,ekubric}.yaml, which differ from it in the losses
    alone."""
    losses = NS(level_weights=[8, 4, 2, 1, 0.5], order=order)
    return NS(
        name="RPEFlow",
        freeze_bn=False,
        ids=NS(enabled=True, sensor_size_divisor=32),
        pwc2d=NS(event_bins=10, event_polarity=True, max_displacement=4,
                 norm=NS(feature_pyramid="batch_norm", flow_estimator=None,
                         context_network=None)),
        pwc3d=NS(k=16, norm=NS(feature_pyramid="batch_norm", correlation=None,
                               flow_estimator=None)),
        loss2d=losses,
        loss3d=losses,
    )


def training_cfg():
    """Training block of conf/train/pretrain.yaml."""
    return NS(max_epochs=600, optimizer="adam", weight_decay=1e-6, bias_decay=0.0,
              lr=NS(scheduler="MultiStepLR", init_value=4e-4, momentum=0.9, decay_rate=0.5,
                    decay_milestones=[400, 500]))


def dsec_training_cfg():
    """Training block of conf/train/dsec.yaml (and conf/train/ekubric.yaml)."""
    return NS(max_epochs=300, optimizer="adam", weight_decay=1e-6, bias_decay=0.0,
              lr=NS(scheduler="MultiStepLR", init_value=1e-4, momentum=0.9, decay_rate=0.5,
                    decay_milestones=[150, 250]))


def make_batch(seed, b, h, w, n, event_ch, device, targets=False, f=1050.0):
    """Synthetic FT3D-like batch whose points project inside the image
    (camera of focal length ``f``)."""
    g = torch.Generator().manual_seed(seed)
    cx, cy = (w - 1) / 2, (h - 1) / 2
    z = 2.0 + 33.0 * torch.rand(b, n, generator=g)
    u = torch.rand(b, n, generator=g) * (w - 1)
    v = torch.rand(b, n, generator=g) * (h - 1)
    pc1 = torch.stack([(u - cx) * z / f, (v - cy) * z / f, z], -1)
    flow3d = 0.1 * torch.randn(b, n, 3, generator=g)
    batch = {
        "images": torch.randint(0, 256, (b, h, w, 6), generator=g, dtype=torch.uint8),
        "pcs": torch.cat([pc1, pc1 + flow3d], -1),
        "event_voxel": torch.rand(b, h, w, event_ch, generator=g),
        "intrinsics": torch.tensor([[f, cx, cy]]).repeat(b, 1),
    }
    if targets:
        batch["flow_2d"] = torch.cat([4 * torch.randn(b, h, w, 2, generator=g),
                                      torch.ones(b, h, w, 1)], -1)
        batch["occ_mask_3d"] = (torch.rand(b, n, generator=g) > 0.8).float()
        # 4th channel: the loss's validity mask (non-occluded points)
        batch["flow_3d"] = torch.cat([flow3d, 1.0 - batch["occ_mask_3d"][..., None]], -1)
    return {k: t.to(device) for k, t in batch.items()}


def make_dsec_batch(seed, b, h, w, n, event_ch, device, targets=False):
    """Synthetic batch in DSEC's form (``DSECTrain.__getitem__``): DSEC's
    camera, and as targets a sparse ``flow_2d`` whose validity channel marks
    about :data:`DSEC_VALID` of the pixels, ``flow_3d`` whose validity channel is 1
    (the dataset keeps only points with ground truth), and no
    ``occ_mask_3d``."""
    batch = make_batch(seed, b, h, w, n, event_ch, "cpu", targets=targets, f=DSEC_FOCAL)
    if targets:
        g = torch.Generator().manual_seed(seed + 1)
        del batch["occ_mask_3d"]
        batch["flow_2d"][..., 2] = (torch.rand(b, h, w, generator=g) < DSEC_VALID).float()
        batch["flow_3d"][..., 3] = 1.0
    return {k: t.to(device) for k, t in batch.items()}


def n_samples(points: int, levels: int) -> tuple:
    """Points kept at each of ``levels`` decode levels of a ``points``-point
    cloud, halving from ``points / 2`` (:data:`N_SAMPLES` for 8192 and 5)."""
    return tuple(points >> (i + 1) for i in range(levels))
