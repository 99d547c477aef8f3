"""Scene-graph nodes with per-frame pose data (port of
neuralsim_tpu/scene/nodes.py:26-150).

A node's per-frame attributes are ``[T, ...]`` tensors over the scene's T
frames: ``transform`` [T, 4, 4] (relative to the parent), ``scale`` [T, 3]
(kept out of the 4x4), ``valid`` [T] (the node exists at that frame), plus
whatever else the scenario gives (a camera's ``intr``, ``hw``; ``global_ts``).
Frames outside a node's segments hold the identity and are invalid. Floating
arrays are kept as float32, as the JAX package keeps them.

``interp_at`` freezes a node at continuous timestamps: between the two
keyframes that bracket each timestamp on the node's clock, the rotation by
slerp and the position, scale and every other float attribute by lerp.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..maths.transforms import clip, lerp, make_transform, quat_slerp, quat_to_rot, rot_to_quat


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

    def interp_at(self, ts, default_table: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """Every attribute at timestamps ``ts`` (a number or a tensor): the
        bracket [lo, hi] by ``searchsorted(side="right")`` on the node's
        ``global_ts`` (without one, ``default_table``, the scene's clock,
        the bracket clipped to the shorter of the two; without either, the
        frame indices), the weight w = clip((ts - t_lo) / max(t_hi - t_lo,
        1e-9), 0, 1); ``valid`` where both keyframes are; an attribute that is
        no float (and ``global_ts``) from lo."""
        table = self.frame_data.get("global_ts")
        dev = self.frame_data["transform"].device
        max_fi = self.n_frames - 1
        if table is None:
            if default_table is not None:
                table = default_table
                max_fi = min(len(table), self.n_frames) - 1
            else:
                table = torch.arange(self.n_frames, dtype=torch.float32, device=dev)
        ts = torch.as_tensor(ts, dtype=table.dtype, device=dev)
        hi = torch.clamp(torch.searchsorted(table, ts, right=True), 1, max_fi)
        lo = hi - 1
        t0, t1 = table[lo], table[hi]
        w = clip((ts - t0) / torch.maximum(t1 - t0, t1.new_full((), 1e-9)), 0.0, 1.0)
        fd = self.frame_data
        T0, T1 = fd["transform"][lo], fd["transform"][hi]
        q0, q1 = rot_to_quat(T0[..., :3, :3]), rot_to_quat(T1[..., :3, :3])
        q = quat_slerp(q0, q1, w[..., None] if w.dim() < q0.dim() - 1 else w)
        out = {"transform": make_transform(quat_to_rot(q),
                                           lerp(T0[..., :3, 3], T1[..., :3, 3], w[..., None])),
               "scale": lerp(fd["scale"][lo], fd["scale"][hi], w[..., None]),
               "valid": fd["valid"][lo] & fd["valid"][hi]}
        for k, v in fd.items():
            if k in out:
                continue
            if k != "global_ts" and v.is_floating_point():
                vl, vh = v[lo], v[hi]
                out[k] = lerp(vl, vh, w.reshape(w.shape + (1,) * (vl.dim() - w.dim())))
            else:
                out[k] = v[lo]
        return out
