"""The scene graph: nodes in parent-before-child order, frame slicing and
world transforms (port of neuralsim_tpu/scene/scene.py:26-151, 154-244).

``Scene.slice_at(fi)`` freezes the graph at one frame, or at one frame per ray
(``fi`` a tensor [N] of frame indices, as a training batch mixes frames): a
:class:`FrozenScene` holds every node's attributes at that frame ([N, ...] per
ray) and its world transform ([N, 4, 4]), composed root to leaf in one loop
over the nodes with broadcasting products. A camera that is a child of the
ego car gets its pose from the car's.

Pose refinement: ``slice_at(fi, pose_deltas)`` and ``interp_at(ts,
pose_deltas)`` take a ``LearnableParams`` tree {node: {dquat, dtrans, dintr?}}
and apply each node's deltas at its frame to the node's own (parent-relative)
transform and intrinsics before the root-to-leaf composition, under autograd,
so that the loss reaches them. ``interp_at`` freezes the graph at continuous
timestamps (timestamp mode, ``use_ts_interp``), each node's deltas those of its
keyframe at or before the timestamp; ``sensor_ts`` gives a sensor's timestamps
at frame indices, with its ``dts`` refinement added.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

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

    def slice_at(self, fi, pose_deltas: Optional[Mapping[str, Mapping]] = None) -> FrozenScene:
        """Freeze at integer frame index ``fi``, or at a tensor [N] of frame
        indices (one per ray, on the scene's device). ``pose_deltas``: a
        ``LearnableParams`` tree, each node's deltas taken at ``fi``."""
        data = []
        for n in self.nodes_topo:
            d = n.slice_at(fi)
            if pose_deltas and n.id in pose_deltas:
                d = self._apply_node_deltas(d, pose_deltas[n.id], fi)
            data.append(d)
        return FrozenScene(self, data)

    @staticmethod
    def _apply_node_deltas(d: Dict[str, Any], pd: Mapping[str, torch.Tensor], fi
                           ) -> Dict[str, Any]:
        """One node's frame data with its entry of the tree applied at frame
        index ``fi``: dquat and dtrans to the transform, dintr to ``intr``."""
        from ..models.assets import LearnableParams
        d = dict(d)
        if "dquat" in pd:
            d["transform"] = LearnableParams.apply_delta(d["transform"], pd["dquat"][fi],
                                                         pd["dtrans"][fi])
        if "dintr" in pd and "intr" in d:
            d["intr"] = LearnableParams.apply_intr_delta(d["intr"], pd["dintr"][fi])
        return d

    def _default_ts_table(self) -> torch.Tensor:
        """The clock of the nodes without their own ``global_ts`` (annotated
        objects): the first node's that has one, else the frame indices."""
        for n in self.nodes_topo:
            t = n.frame_data.get("global_ts")
            if t is not None:
                return t
        dev = self.nodes_topo[0].frame_data["transform"].device
        return torch.arange(self.n_frames, dtype=torch.float32, device=dev)

    def interp_at(self, ts, pose_deltas: Optional[Mapping[str, Mapping]] = None
                  ) -> FrozenScene:
        """Freeze at continuous timestamps ``ts`` (a number, or a tensor [N]
        one per ray): each node by :meth:`SceneNode.interp_at` on its clock;
        ``pose_deltas`` taken at each node's keyframe at or before ``ts``
        (constant between keyframes)."""
        default_table = self._default_ts_table()
        data = []
        for n in self.nodes_topo:
            d = n.interp_at(ts, default_table=default_table)
            if pose_deltas and n.id in pose_deltas:
                table = n.frame_data.get("global_ts")
                table = default_table if table is None else table
                t = torch.as_tensor(ts, dtype=table.dtype, device=table.device)
                lo = torch.clamp(torch.searchsorted(table, t, right=True) - 1, 0,
                                 n.n_frames - 1)
                d = self._apply_node_deltas(d, pose_deltas[n.id], lo)
            data.append(d)
        return FrozenScene(self, data)

    def sensor_ts(self, node_id: str, fidx, dts: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """Node ``node_id``'s timestamps at frame indices ``fidx`` (its
        ``global_ts``, else the indices), plus ``dts``: one offset [1] for
        every frame, or a delta a frame [T]."""
        n = self.nodes[node_id]
        table = n.frame_data.get("global_ts")
        if table is None:
            table = torch.arange(n.n_frames, dtype=torch.float32,
                                 device=n.frame_data["transform"].device)
        ts = table[fidx]
        if dts is not None:
            ts = ts + (dts[0] if dts.shape[0] == 1 else dts[fidx])
        return ts

    def drawable_ids(self) -> List[str]:
        return list(self.drawables)

    def observer_ids(self) -> List[str]:
        return list(self.observers)
