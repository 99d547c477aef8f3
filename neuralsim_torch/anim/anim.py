"""Node trajectories for re-simulation (port of neuralsim_tpu/anim/anim.py:20-124).

An animation replaces the per-frame ``transform`` [T, 4, 4] of some scene
nodes before the scene is sliced, so that a render replays the recording
with edited motion:

- ``FileAnim``: trajectories from a file, npz (one array per node id) or json
  ({node id: [[4x4], ...]}), each [T, 4, 4] or [T, 7] (position and a w, x,
  y, z quaternion, turned into a rotation by ``maths.transforms.quat_to_rot``);
  a shorter track holds its last pose, a longer one is cut;
- ``ReverseEgoAnim``: a node's (by default the ego car's) track played
  backwards.

A node's transform is relative to its parent, so a camera that rides the ego
car follows the car's new track. The new tracks are float32 tensors on the
device of the node's own.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch

from ..maths.transforms import quat_to_rot


def _set_transform(node, tr) -> None:
    dev = node.frame_data["transform"].device
    node.frame_data = dict(node.frame_data)
    node.frame_data["transform"] = torch.as_tensor(np.asarray(tr, np.float32), device=dev)


class Anim:
    """Base: maps (node id, frame count) to a replacement track, or None."""

    def transforms_for(self, node_id: str, n_frames: int) -> Optional[np.ndarray]:
        return None

    def apply(self, scene) -> None:
        for node in scene.nodes_topo:
            tr = self.transforms_for(node.id, node.n_frames)
            if tr is not None:
                _set_transform(node, tr)


class FileAnim(Anim):
    """Trajectories from an ``.npz`` or ``.json`` file (another suffix raises)."""

    def __init__(self, path: str):
        self.data: Dict[str, np.ndarray] = {}
        if path.endswith(".npz"):
            with np.load(path) as z:
                for k in z.files:
                    self.data[k] = z[k]
        elif path.endswith(".json"):
            with open(path) as f:
                self.data = {k: np.asarray(v, np.float32) for k, v in json.load(f).items()}
        else:
            raise ValueError(f"unsupported anim file {path}")

    def transforms_for(self, node_id, n_frames):
        tr = self.data.get(node_id)
        if tr is None:
            return None
        tr = np.asarray(tr, np.float32)
        if tr.ndim == 2 and tr.shape[-1] == 7:      # position + quaternion (w, x, y, z)
            R = quat_to_rot(torch.from_numpy(np.ascontiguousarray(tr[:, 3:]))).numpy()
            out = np.tile(np.eye(4, dtype=np.float32), (tr.shape[0], 1, 1))
            out[:, :3, :3] = R
            out[:, :3, 3] = tr[:, :3]
            tr = out
        if tr.shape[0] < n_frames:                  # hold the last pose
            tr = np.concatenate([tr, np.repeat(tr[-1:], n_frames - tr.shape[0], 0)], 0)
        return tr[:n_frames]


class ReverseEgoAnim(Anim):
    """Play node ``node_id``'s track (default ``ego``) backwards."""

    def __init__(self, node_id: str = "ego"):
        self.node_id = node_id

    def apply(self, scene) -> None:
        node = scene.nodes[self.node_id]
        node.frame_data = dict(node.frame_data)
        node.frame_data["transform"] = torch.flip(node.frame_data["transform"], [0])


def create_anim(cfg, scene=None) -> Anim:
    """The animation of ``render.anim``: a file's path (``FileAnim``),
    ``"reverse_ego"`` or ``"reverse_ego:<node id>"`` (``ReverseEgoAnim``), or
    a dict {type: file | reverse_ego, path, node_id}. Without a node id the
    ego is the scene's ``metas["ego_car_id"]``, else its first
    ``EgoVehicle``, else the topmost ancestor of its first camera (a scene
    without an ego car), else ``"ego"``."""
    def default_ego():
        if scene is not None:
            eid = scene.metas.get("ego_car_id")
            if eid and eid in scene.nodes:
                return eid
            for n in scene.nodes_topo:
                if n.class_name == "EgoVehicle":
                    return n.id
            for n in scene.nodes_topo:
                if n.class_name == "Camera":
                    nid = n.id
                    while scene.nodes[nid].parent is not None:
                        nid = scene.nodes[nid].parent
                    return nid
        return "ego"

    if isinstance(cfg, str):
        if cfg.startswith("reverse_ego"):
            _, _, nid = cfg.partition(":")
            return ReverseEgoAnim(nid or default_ego())
        return FileAnim(cfg)
    t = cfg.get("type", "file")
    if t == "reverse_ego":
        return ReverseEgoAnim(cfg.get("node_id") or default_ego())
    if t == "file":
        return FileAnim(cfg["path"])
    raise ValueError(f"unknown anim type {t}")
