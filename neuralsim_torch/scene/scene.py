"""The scene graph: nodes in parent-before-child order, frame slicing and
world transforms (port of neuralsim_tpu/scene/scene.py:26-151, 154-171,
240-244).

``Scene.slice_at(fi)`` freezes the graph at one frame, or at one frame per ray
(``fi`` a tensor [N] of frame indices, as a training batch mixes frames): a
:class:`FrozenScene` holds every node's attributes at that frame ([N, ...] per
ray) and its world transform ([N, 4, 4]), composed root to leaf in one loop
over the nodes with broadcasting products. A camera that is a child of the
ego car gets its pose from the car's.

Not ported yet: pose deltas (pose refinement) and ``interp_at``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..maths.transforms import (apply_rotation, apply_transform, compose_transforms,
                                inverse_transform, norm3)
from .nodes import SceneNode

OBSERVER_CLASSES = ("Camera", "RaysLidar", "Lidar", "OrthoCamera", "PanoramaCamera")
NON_DRAWABLE_CLASSES = ("EgoVehicle", "node", "World")


class FrozenScene:
    """A scene frozen at one frame: per-node attributes and world transforms."""

    def __init__(self, scene: "Scene", node_data: List[Dict[str, Any]]):
        self.scene = scene
        self.node_data = node_data            # indexed by node.index
        self.world: List[torch.Tensor] = []
        for node in scene.nodes_topo:
            local = node_data[node.index]["transform"]
            self.world.append(local if node.parent_index < 0 else
                              compose_transforms(self.world[node.parent_index], local))

    def world_transform(self, node_id: str) -> torch.Tensor:
        return self.world[self.scene.nodes[node_id].index]

    def data(self, node_id: str) -> Dict[str, Any]:
        return self.node_data[self.scene.nodes[node_id].index]

    def valid(self, node_id: str) -> torch.Tensor:
        return self.data(node_id)["valid"]

    def rays_to_node(self, node_id: str, rays_o: torch.Tensor, rays_d: torch.Tensor):
        """World rays -> the node's canonical frame (divided by its scale):
        (origins, unit directions, the direction's length before
        normalising, which turns a local depth into a world depth)."""
        idx = self.scene.nodes[node_id].index
        w2n = inverse_transform(self.world[idx])
        scale = self.node_data[idx]["scale"]
        o = apply_transform(w2n, rays_o) / scale
        d = apply_rotation(w2n, rays_d) / scale
        dn = norm3(d)
        return o, d / torch.clamp(dn[..., None], min=1e-9), dn


class Scene:
    """Scene-graph container parsed from the universal scenario format."""

    def __init__(self, scene_id: str = "scene", metas: Optional[Dict] = None):
        self.id = scene_id
        self.metas = dict(metas or {})
        self.nodes: Dict[str, SceneNode] = {}
        self.nodes_topo: List[SceneNode] = []
        self.observers: Dict[str, SceneNode] = {}
        self.drawables: Dict[str, SceneNode] = {}
        self.n_frames = 0

    def add_node(self, node: SceneNode) -> SceneNode:
        self.nodes[node.id] = node
        return node

    def finalize(self) -> "Scene":
        """Order the nodes parents first, index them, and sort them into
        observers and drawables."""
        order: List[SceneNode] = []
        seen = set()

        def visit(n: SceneNode):
            if n.id in seen:
                return
            if n.parent and n.parent in self.nodes:
                visit(self.nodes[n.parent])
            seen.add(n.id)
            order.append(n)

        for n in self.nodes.values():
            visit(n)
        self.nodes_topo = order
        for i, n in enumerate(order):
            n.index = i
            n.parent_index = self.nodes[n.parent].index \
                if (n.parent and n.parent in self.nodes) else -1
        for n in order:
            if n.class_name in OBSERVER_CLASSES:
                self.observers[n.id] = n
            elif n.class_name not in NON_DRAWABLE_CLASSES:
                self.drawables[n.id] = n
        return self

    @classmethod
    def load_from_scenario(cls, scenario: Dict, device="cpu") -> "Scene":
        """Build the node tree from a scenario dict (observers, then objects;
        an entry's ``children`` hang below it), its tensors on ``device``."""
        metas = scenario.get("metas", {})
        sc = cls(scenario.get("scene_id", "scene"), metas)
        T = int(metas.get("num_frames", 0))

        def add_group(group: Dict, default_parent=None):
            for nid, odict in group.items():
                sc.add_node(SceneNode.from_odict(nid, odict, T, odict.get("parent", default_parent),
                                                 device))
                for cid, codict in odict.get("children", {}).items():
                    sc.add_node(SceneNode.from_odict(cid, codict, T, nid, device))

        add_group(scenario.get("observers", {}))
        add_group(scenario.get("objects", {}))
        sc.n_frames = T
        return sc.finalize()

    def slice_at(self, fi) -> FrozenScene:
        """Freeze at integer frame index ``fi``, or at a tensor [N] of frame
        indices (one per ray, on the scene's device)."""
        return FrozenScene(self, [n.slice_at(fi) for n in self.nodes_topo])

    def drawable_ids(self) -> List[str]:
        return list(self.drawables)

    def observer_ids(self) -> List[str]:
        return list(self.observers)
