"""The training log and image writing of the tools (port of
neuralsim_tpu/utils/logger.py: ``Logger``'s scalars and ``save_stats``,
``_write_png``, ``color_depth`` and ``scene_flow_to_rgb``; numpy, on the
host).

``Logger`` appends each logged scalar to ``metrics.jsonl`` under its root and
keeps them for ``save_stats`` (a pickle of {tag: [(step, value)]},
``stats.p``), as the JAX package does where tensorboard is missing (its
image galleries are not ported).
"""
from __future__ import annotations

import json
import os
import pickle
import struct
import time
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np


class Logger:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.stats: Dict[str, List[Tuple[int, float]]] = {}
        os.makedirs(self.root, exist_ok=True)
        self._jsonl = open(os.path.join(self.root, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        v = float(value)
        self.stats.setdefault(tag, []).append((step, v))
        self._jsonl.write(json.dumps({"t": time.time(), "step": step, tag: v}) + "\n")

    def add_scalars(self, metrics: Dict[str, Any], step: int, prefix: str = "") -> None:
        """Every scalar of ``metrics`` (numbers or 0-d arrays and tensors)."""
        for k, v in metrics.items():
            if np.ndim(v) == 0:
                self.add_scalar(prefix + k, v, step)
        self._jsonl.flush()

    def save_stats(self, name: str = "stats.p") -> None:
        with open(os.path.join(self.root, name), "wb") as f:
            pickle.dump(self.stats, f)

    def close(self) -> None:
        self._jsonl.close()


def _write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``img`` [H, W, 3] (or [H, W], repeated) uint8,
    encoded with zlib alone."""
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(typ, data):
        c = struct.pack(">I", len(data)) + typ + data
        return c + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def color_depth(depth: np.ndarray) -> np.ndarray:
    """Depth -> RGB in [0, 1] on a turbo-like ramp from the smallest depth
    to the 99th percentile."""
    d = np.asarray(depth, np.float32)
    near, far = np.nanmin(d), np.nanpercentile(d, 99)
    t = np.clip((d - near) / max(far - near, 1e-9), 0, 1)
    r = np.clip(1.5 - np.abs(2.0 * t - 1.0) * 2.0, 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * t - 0.5) * 2.0, 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * t) * 2.0, 0, 1)
    return np.stack([r, g, b], -1)


def scene_flow_to_rgb(flow: np.ndarray, flow_max_radius: float = 0.5,
                      plane: tuple = (0, 1)) -> np.ndarray:
    """3-D scene flow [..., 3] -> RGB in [0, 1] on the optical-flow colour
    wheel of two of its components (``plane``): the direction the hue, the
    magnitude clipped at ``flow_max_radius`` the saturation, the value 1 (no
    flow is white)."""
    f = np.asarray(flow, np.float32)
    fx, fy = f[..., plane[0]], f[..., plane[1]]
    mag = np.sqrt(fx * fx + fy * fy)
    hue = (np.arctan2(fy, fx) / (2.0 * np.pi)) % 1.0
    sat = np.clip(mag / max(flow_max_radius, 1e-9), 0.0, 1.0)
    h6 = hue * 6.0
    i = np.floor(h6).astype(np.int32) % 6
    frac = h6 - np.floor(h6)
    p, q, t = 1.0 - sat, 1.0 - sat * frac, 1.0 - sat * (1.0 - frac)
    one = np.ones_like(sat)
    lut = np.stack([np.stack([one, t, p], -1), np.stack([q, one, p], -1),
                    np.stack([p, one, t], -1), np.stack([p, q, one], -1),
                    np.stack([t, p, one], -1), np.stack([one, p, q], -1)], 0)
    return np.take_along_axis(lut, i[None, ..., None], axis=0)[0]
