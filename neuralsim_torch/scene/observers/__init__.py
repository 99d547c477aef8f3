"""Scene observers: cameras and LiDARs."""
from .cameras import camera_get_all_rays, camera_get_selected_rays
from .lidars import lidar_rays_to_world, make_lidar_generator

__all__ = ["camera_get_all_rays", "camera_get_selected_rays", "lidar_rays_to_world",
           "make_lidar_generator"]
