"""Animation: node trajectories from files, or the ego's played backwards,
for re-simulation."""
from .anim import Anim, FileAnim, ReverseEgoAnim, create_anim

__all__ = ["Anim", "FileAnim", "ReverseEgoAnim", "create_anim"]
