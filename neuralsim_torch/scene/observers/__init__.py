"""Scene observers: cameras."""
from .cameras import camera_get_all_rays, camera_get_selected_rays

__all__ = ["camera_get_all_rays", "camera_get_selected_rays"]
