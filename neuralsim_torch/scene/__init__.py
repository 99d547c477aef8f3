"""The scene graph, the asset bank and the camera observers."""
from .asset_bank import AssetBank
from .nodes import SceneNode
from .scene import FrozenScene, Scene

__all__ = ["AssetBank", "FrozenScene", "Scene", "SceneNode"]
