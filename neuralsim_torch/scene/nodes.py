"""Scene-graph nodes with per-frame pose data (port of
neuralsim_tpu/scene/nodes.py:26-104).

A node's per-frame attributes are ``[T, ...]`` tensors over the scene's T
frames: ``transform`` [T, 4, 4] (relative to the parent), ``scale`` [T, 3]
(kept out of the 4x4), ``valid`` [T] (the node exists at that frame), plus
whatever else the scenario gives (a camera's ``intr``, ``hw``; ``global_ts``).
Frames outside a node's segments hold the identity and are invalid. Floating
arrays are kept as float32, as the JAX package keeps them.

Not ported yet: ``interp_at`` (continuous timestamps).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _tensor(v: np.ndarray, device) -> torch.Tensor:
    if np.issubdtype(v.dtype, np.floating):
        v = v.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


class SceneNode:
    """Static node metadata and its per-frame attribute tensors."""

    def __init__(self, node_id: str, class_name: str = "node",
                 parent: Optional[str] = None):
        self.id = node_id
        self.class_name = class_name
        self.parent = parent
        self.frame_data: Dict[str, torch.Tensor] = {}
        self.n_frames = 0
        # set by Scene.finalize
        self.index = -1
        self.parent_index = -1

    @classmethod
    def from_odict(cls, node_id: str, odict: Dict, n_scene_frames: int,
                   parent: Optional[str] = None, device="cpu") -> "SceneNode":
        """Parse one scenario entry: flat ``data`` over the first ``n_frames``
        frames, ``segments`` [{start_frame, n_frames, data}], or neither (a
        static node, valid everywhere)."""
        node = cls(node_id, odict.get("class_name", "node"), parent)
        T = n_scene_frames
        transform = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
        scale = np.ones((T, 3), np.float32)
        valid = np.zeros((T,), bool)
        extra: Dict[str, np.ndarray] = {}

        def fill(data: Dict, start: int, n: int):
            sl = slice(start, start + n)
            for k, v in data.items():
                v = np.asarray(v)
                if v.ndim and v.shape[0] > n:       # tolerate over-long arrays
                    v = v[:n]
                if k == "transform":
                    transform[sl] = v.astype(np.float32).reshape(n, 4, 4)
                elif k == "scale":
                    scale[sl] = np.broadcast_to(v.astype(np.float32).reshape(n, -1), (n, 3))
                else:
                    if k not in extra:
                        extra[k] = np.zeros((T,) + v.shape[1:], v.dtype)
                    extra[k][sl] = v
            valid[sl] = True

        if "segments" in odict:
            for seg in odict["segments"]:
                fill(seg["data"], int(seg.get("start_frame", 0)), int(seg["n_frames"]))
        elif "data" in odict:
            fill(odict["data"], 0, int(odict.get("n_frames", T)))
        else:
            valid[:] = True

        node.frame_data = {"transform": _tensor(transform, device),
                           "scale": _tensor(scale, device), "valid": _tensor(valid, device)}
        for k, v in extra.items():
            node.frame_data[k] = _tensor(v, device)
        node.n_frames = T
        return node

    def slice_at(self, fi) -> Dict[str, Any]:
        """Every attribute at integer frame index ``fi`` (an int, or a tensor
        of indices for a batch)."""
        return {k: v[fi] for k, v in self.frame_data.items()}
