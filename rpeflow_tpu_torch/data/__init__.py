"""Host-side data pipeline: datasets, loader, augmentation, event handling.

The port's copy of ``rpeflow_tpu.data`` (numpy host code, the same names).
Importing it pulls in neither ``cv2``, ``h5py`` nor ``yaml``: each is imported
by the function that reads such a file.
"""

from .dataset import ConcatDataset, Dataset
from .dsec import DSECPreprocessTrain, DSECTrain
from .event_voxel import events_to_voxel, load_events_h5
from .flyingthings3d import FlyingThings3D, FlyingThings3DEvent
from .kubric import KubricData
from .loader import DataLoader, collate

__all__ = [
    "ConcatDataset",
    "DSECPreprocessTrain",
    "DSECTrain",
    "DataLoader",
    "Dataset",
    "FlyingThings3D",
    "FlyingThings3DEvent",
    "KubricData",
    "collate",
    "events_to_voxel",
    "load_events_h5",
]
