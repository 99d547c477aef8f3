"""Occupancy acceleration: the EMA occupancy grids and their ray proposal."""
from .occ_grid import OccGridEma, OccGridEmaBatched, OccGridEmaDynamic, OccGridState

__all__ = ["OccGridEma", "OccGridEmaBatched", "OccGridEmaDynamic", "OccGridState"]
