"""Host-side utilities of the port (numpy only): visualization."""

from .visualization import event_voxel_to_image, flow_to_image, scene_flow_to_image

__all__ = ["event_voxel_to_image", "flow_to_image", "scene_flow_to_image"]
