"""Utilities of the port: visualization (numpy only), and the tools' device
selection and timing (:mod:`.timing`)."""

from .visualization import event_voxel_to_image, flow_to_image, scene_flow_to_image

__all__ = ["event_voxel_to_image", "flow_to_image", "scene_flow_to_image"]
