"""Dataset and model factories (the port's copy of ``rpeflow_tpu/train/factory.py``).

The JAX package's KNN-backend switch has no counterpart: the port's KNN is
exact.
"""

from __future__ import annotations

from ..data import (
    ConcatDataset,
    DSECPreprocessTrain,
    DSECTrain,
    FlyingThings3D,
    FlyingThings3DEvent,
    KubricData,
)
from ..model import DEFAULT_N_SAMPLES, RPEFlow


def dataset_factory_single(cfgs):
    name = cfgs.name
    if name == "flyingthings3d":
        return FlyingThings3D(cfgs)
    if name == "flyingthings3devent":
        return FlyingThings3DEvent(cfgs)
    if name == "kubric":
        return KubricData(cfgs)
    if name == "dsectrain":
        return DSECTrain(cfgs)
    if name == "dsecpreprocesstrain":
        return DSECPreprocessTrain(cfgs)
    raise NotImplementedError(f"Unknown dataset: {name}")


def dataset_factory(cfgs):
    """Single dataset, or ConcatDataset of trainset1..3."""
    if "trainset1" in cfgs:
        datasets = [dataset_factory_single(cfgs.trainset1)]
        if "trainset2" in cfgs:
            datasets.append(dataset_factory_single(cfgs.trainset2))
        if "trainset3" in cfgs:
            datasets.append(dataset_factory_single(cfgs.trainset3))
        return ConcatDataset(datasets)
    return dataset_factory_single(cfgs)


def model_factory(cfgs, amp: bool = False) -> RPEFlow:
    """The model of a ``model`` config block; ``amp`` runs its two 2-D
    feature pyramids in bfloat16 (the training config's ``amp: true``)."""
    if cfgs.name != "RPEFlow":
        raise NotImplementedError(f"Unknown model name: {cfgs.name}")
    return RPEFlow(cfgs, tuple(getattr(cfgs, "n_samples", DEFAULT_N_SAMPLES)), amp=amp)
