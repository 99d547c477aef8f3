"""Occupancy acceleration: the EMA occupancy grid and its ray proposal."""
from .occ_grid import OccGridEma, OccGridState

__all__ = ["OccGridEma", "OccGridState"]
