"""Error-map importance sampling (port of
neuralsim_tpu/training/error_map.py:22-125; numpy, on the host).

An :class:`ErrorMap` is a low-resolution [n_frames, h, w] grid of photometric
errors per camera, splatted from each pixel step's per-ray errors with an
EMA; :class:`ImpSampler` draws (frame, pixel) jointly from it, mixed with a
uniform share, once ``enable_after`` error updates have come in. Sampling
runs on the host, outside the training step, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


class ErrorMap:
    def __init__(self, n_frames: int, hw: Tuple[int, int] = (32, 64), *,
                 ema: float = 0.9, init_val: float = 1.0):
        self.n_frames = n_frames
        self.h, self.w = hw
        self.ema = ema
        self.map = np.full((n_frames, self.h, self.w), init_val, np.float64)

    def step_error_map(self, fidx: np.ndarray, xy01: np.ndarray,
                       err: np.ndarray) -> None:
        """Splat per-ray errors (xy01 in [0,1]^2) into the grid with EMA.

        Errors are sanitized: ONE transient NaN ray would otherwise poison
        its cell forever and eventually crash the CDF sampler
        ("Probabilities contain NaN" — r4 6000-iter demo)."""
        err = np.nan_to_num(np.asarray(err, np.float64), nan=0.0,
                            posinf=0.0, neginf=0.0)
        xs = np.clip((xy01[:, 0] * self.w).astype(int), 0, self.w - 1)
        ys = np.clip((xy01[:, 1] * self.h).astype(int), 0, self.h - 1)
        flat = self.map.reshape(self.n_frames, -1)
        cell = ys * self.w + xs
        # mean error per touched cell, EMA-merged
        acc = np.zeros_like(flat)
        cnt = np.zeros_like(flat)
        np.add.at(acc, (fidx, cell), err)
        np.add.at(cnt, (fidx, cell), 1.0)
        touched = cnt > 0
        flat[touched] = self.ema * flat[touched] + \
            (1.0 - self.ema) * (acc[touched] / cnt[touched])

    # -- sampling -------------------------------------------------------------
    def sample_joint(self, rng: np.random.Generator, n: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Draw (frame, cell) jointly from the error distribution; returns
        (fidx [n], xy01 [n, 2]) with uniform jitter inside cells."""
        p = np.nan_to_num(self.map.reshape(-1), nan=0.0, posinf=0.0)
        s = p.sum()
        p = p / s if s > 0 else np.full_like(p, 1.0 / p.size)
        idx = rng.choice(p.size, size=n, p=p)
        fidx = idx // (self.h * self.w)
        cell = idx % (self.h * self.w)
        ys, xs = cell // self.w, cell % self.w
        u = rng.random((n, 2))
        xy01 = np.stack([(xs + u[:, 0]) / self.w, (ys + u[:, 1]) / self.h], -1)
        return fidx.astype(np.int32), xy01


class ImpSampler:
    """Mix of uniform and error-map-driven (frame, pixel) sampling
    (reference ImpSampler({name: (map, frac)}, frac_uniform)).

    Keeps ONE error map PER CAMERA (lazily cloned from the template map), so
    multi-camera rigs don't conflate per-camera photometric errors — matching
    the reference's per-camera ``ErrorMap`` dict."""

    def __init__(self, error_map: ErrorMap, *, frac_uniform: float = 0.5,
                 enable_after: int = 0):
        self.error_map = error_map            # template (also the default map)
        self.maps: Dict[str, ErrorMap] = {}
        self.frac_uniform = frac_uniform
        self.enable_after = enable_after
        self.it = 0

    def _map_for(self, cam_id: str) -> ErrorMap:
        m = self.maps.get(cam_id)
        if m is None:
            t = self.error_map
            m = ErrorMap(t.n_frames, (t.h, t.w), ema=t.ema)
            m.map[:] = t.map
            self.maps[cam_id] = m
        return m

    def sample(self, rng: np.random.Generator, cam_id: str, n: int,
               H: int, W: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (fidx [n], xs [n], ys [n]) integer pixel coords."""
        emap = self._map_for(cam_id)
        if self.it < self.enable_after:
            fidx = rng.integers(0, emap.n_frames, n)
            return fidx.astype(np.int32), rng.integers(0, W, n), rng.integers(0, H, n)
        n_uni = int(n * self.frac_uniform)
        n_imp = n - n_uni
        f_u = rng.integers(0, emap.n_frames, n_uni).astype(np.int32)
        x_u = rng.integers(0, W, n_uni)
        y_u = rng.integers(0, H, n_uni)
        f_i, xy01 = emap.sample_joint(rng, n_imp)
        x_i = np.clip((xy01[:, 0] * W).astype(int), 0, W - 1)
        y_i = np.clip((xy01[:, 1] * H).astype(int), 0, H - 1)
        return (np.concatenate([f_u, f_i]), np.concatenate([x_u, x_i]),
                np.concatenate([y_u, y_i]))

    def update(self, fidx: np.ndarray, xs: np.ndarray, ys: np.ndarray,
               err: np.ndarray, H: int, W: int,
               cam_id: Optional[str] = None) -> None:
        xy01 = np.stack([xs / W, ys / H], -1)
        emap = self.error_map if cam_id is None else self._map_for(cam_id)
        emap.step_error_map(fidx, xy01, err)
        self.it += 1
