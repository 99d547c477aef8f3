"""The visible grid (port of neuralsim_tpu/models/misc_assets.py:74-216;
``ColorTransform`` and the forest street stay to be ported).

``VisibleGrid`` voxelises the points a scene's observers see (rendered depth
back-projected, or the LiDAR's returns) over a box, with a hit count a
voxel, closes it by 26-neighbourhood morphology and saves it in the
occupancy-grid npz layout. ``tools/extract_mesh.py --visible_grid`` reads it
to keep the level set inside what was seen. Host numpy (scipy's binary
morphology), as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class VisibleGrid:
    """Accumulates visible voxels from rendered depth maps / LiDAR returns
    (reference app/visible_grid.py:33-232): voxelize back-projected points
    with per-voxel hit counts, apply 26-neighborhood morphology
    (dilation / close / close2 — reference postprocess at
    visible_grid.py:217-232), export, and build an occupancy accel state
    that constrains rendering and mesh extraction
    (reference consumption: code_multi/tools/extract_mesh.py:55-59)."""

    def __init__(self, aabb_min, aabb_max, resolution: int = 128):
        self.aabb_min = np.asarray(aabb_min, np.float32)
        self.aabb_max = np.asarray(aabb_max, np.float32)
        self.res = resolution
        self.grid = np.zeros((resolution,) * 3, bool)
        # per-voxel hit counts (reference voxel_hits_in_block)
        self.hits = np.zeros((resolution,) * 3, np.int64)

    def add_points(self, pts: np.ndarray):
        """Voxelize world points (LiDAR returns or back-projections) —
        reference reduce_points_and_add/reduce_to_voxels
        (visible_grid.py:83-122), dense-grid formulation."""
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        u = (pts - self.aabb_min) / (self.aabb_max - self.aabb_min)
        inside = np.all((u >= 0) & (u < 1), -1)
        c = np.clip((u[inside] * self.res).astype(int), 0, self.res - 1)
        np.add.at(self.hits, (c[:, 0], c[:, 1], c[:, 2]), 1)
        self.grid[c[:, 0], c[:, 1], c[:, 2]] = True

    def add_depth_points(self, rays_o: np.ndarray, rays_d: np.ndarray,
                         depth: np.ndarray, mask: Optional[np.ndarray] = None):
        pts = rays_o + depth[..., None] * rays_d
        if mask is not None:
            pts = pts[mask]
        self.add_points(pts)

    # 26-connectivity structuring element: the reference's neighbor list
    # (visible_grid.py:236-245) is exactly the 3x3x3 cube minus the center.
    _STRUCT = np.ones((3, 3, 3), bool)

    def dilate(self, iterations: int = 1):
        from scipy.ndimage import binary_dilation
        self.grid = binary_dilation(self.grid, structure=self._STRUCT,
                                    iterations=iterations)

    def erode(self, iterations: int = 1, keep: Optional[np.ndarray] = None):
        """26-neighborhood erosion; voxels in ``keep`` are never removed
        (the reference re-asserts the original voxels after erosion so
        boundary voxels survive, visible_grid.py:199-213)."""
        from scipy.ndimage import binary_erosion
        self.grid = binary_erosion(self.grid, structure=self._STRUCT,
                                   iterations=iterations)
        if keep is not None:
            self.grid |= keep

    def postprocess(self, morphology_op: str = "close"):
        """Reference postprocess (visible_grid.py:217-232):
        dilation = one 26-dilate; close = dilate then erode (originals kept);
        close2 = dilate twice then erode twice (originals kept)."""
        if morphology_op not in ("dilation", "close", "close2"):
            raise ValueError(morphology_op)
        original = self.grid.copy()
        self.dilate()
        if morphology_op == "close2":
            self.dilate()
            self.erode(keep=original)
        if morphology_op in ("close", "close2"):
            self.erode(keep=original)
        return self

    def to_occ_state(self, device="cpu"):
        """Export as an ``OccGridState`` on ``device`` (val 1.0 where visible,
        the mask, its occupied fraction), so that the visible grid can serve
        as a renderer's or a marcher's accel."""
        import torch
        from ..accel.occ_grid import OccGridState, occupied_fraction_plain
        mask = torch.from_numpy(self.grid.copy()).to(device)
        return OccGridState(val=mask.to(torch.float32), mask=mask,
                            frac=occupied_fraction_plain(mask))

    def contains(self, pts: np.ndarray) -> np.ndarray:
        """Bool visibility at world points (False outside the AABB)."""
        pts = np.asarray(pts, np.float32)
        u = (pts - self.aabb_min) / (self.aabb_max - self.aabb_min)
        inside = np.all((u >= 0) & (u < 1), -1)
        c = np.clip((u * self.res).astype(int), 0, self.res - 1)
        return self.grid[c[..., 0], c[..., 1], c[..., 2]] & inside

    def voxel_aabbs(self) -> tuple:
        """(mins, maxs) world AABBs of occupied voxels (reference
        get_voxel_aabb_in_world, visible_grid.py:294-299)."""
        coords = np.stack(np.nonzero(self.grid), -1).astype(np.float32)
        vs = (self.aabb_max - self.aabb_min) / self.res
        mins = self.aabb_min + coords * vs
        return mins, mins + vs

    def save(self, path: str):
        coords = np.stack(np.nonzero(self.grid), -1).astype(np.int32)
        np.savez_compressed(path, occ_corners=coords,
                            sidelength=np.array([self.res] * 3, np.int32),
                            aabb_min=self.aabb_min, aabb_max=self.aabb_max,
                            hits=self.hits[coords[:, 0], coords[:, 1],
                                           coords[:, 2]])

    @classmethod
    def load(cls, path: str) -> "VisibleGrid":
        """Inverse of save (reference VisibleGrid.load, visible_grid.py:71)."""
        z = np.load(path)
        vg = cls(z["aabb_min"], z["aabb_max"], int(z["sidelength"][0]))
        c = z["occ_corners"]
        vg.grid[c[:, 0], c[:, 1], c[:, 2]] = True
        if "hits" in z:
            vg.hits[c[:, 0], c[:, 1], c[:, 2]] = z["hits"]
        return vg

    def pyramid(self) -> list:
        """Occupancy mip pyramid (coarse->fine): the dense analog of the
        reference's octree accel over the visible grid
        (app/visible_grid.py:299) — level l voxel is occupied iff any child
        is. Level 0 is 1^3; the last level is the full grid."""
        levels = [self.grid]
        g = self.grid
        while g.shape[0] > 1:
            r = g.shape[0] // 2
            g = g.reshape(r, 2, r, 2, r, 2).any((1, 3, 5))
            levels.append(g)
        return levels[::-1]

    def carve_frustum(self, intr: np.ndarray, c2w: np.ndarray,
                      hw, near: float = 0.0, far: float = np.inf):
        """Keep only voxels inside one camera frustum (logical AND over calls
        carves to the multi-view visible hull — the reference's
        frustum-culling pass)."""
        H, W = hw
        idx = np.stack(np.meshgrid(*([np.arange(self.res)] * 3),
                                   indexing="ij"), -1) + 0.5
        x = self.aabb_min + idx / self.res * (self.aabb_max - self.aabb_min)
        w2c = np.linalg.inv(c2w)
        xc = x.reshape(-1, 3) @ w2c[:3, :3].T + w2c[:3, 3]
        z = xc[:, 2]
        uv = (xc[:, :2] / np.clip(z[:, None], 1e-9, None)) @ \
            np.asarray(intr)[:2, :2].T + np.asarray(intr)[:2, 2]
        ok = ((z > near) & (z < far) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
              & (uv[:, 1] >= 0) & (uv[:, 1] < H))
        self.grid &= ok.reshape(self.grid.shape)
