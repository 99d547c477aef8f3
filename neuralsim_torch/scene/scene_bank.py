"""The scene bank of one dataset: scenario specs, trimming a scenario to a
frame range, and the scenes of a config (port of
neuralsim_tpu/scene/scene_bank.py:18-90).

``create_scene_bank`` reads each scenario the config's ``scenebank_cfg``
names ("scene_id[, start_frame[, n_frames]]"; by default every scene of the
dataset), trims it, keeps a pickle of it under ``exp_dir/scenarios/`` where
an exp dir is given, and builds its :class:`Scene` on the device. Loading a
scene bank back from those pickles and scenes shared across models are not
ported yet.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .scene import Scene


def parse_scene_spec(spec: str) -> Tuple[str, int, Optional[int]]:
    """'scene_id[, start_frame[, n_frames]]' -> (id, start, n or None)."""
    parts = [p.strip() for p in str(spec).split(",")]
    sid = parts[0]
    start = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    n = int(parts[2]) if len(parts) > 2 and parts[2] else None
    return sid, start, n


def slice_scenario(sc: Dict[str, Any], start: int, n: Optional[int]) -> Dict[str, Any]:
    """A scenario trimmed to frames [start, start + n): observers' flat data
    (arrays that run over the frames) and objects' segments, clipped and
    shifted; the scenario itself where the range is all of it."""
    total = int(sc.get("metas", {}).get("num_frames", 0))
    if start == 0 and (n is None or n >= total):
        return sc
    n = min(n or (total - start), total - start)

    def cut(arr):
        a = np.asarray(arr)
        return a[start:start + n] if a.ndim and a.shape[0] >= start + n else a

    def cut_obs(o):
        o = dict(o)
        if "data" in o:
            o["data"] = {k: cut(v) for k, v in o["data"].items()}
            o["n_frames"] = n
        if "children" in o:
            o["children"] = {k: cut_obs(v) for k, v in o["children"].items()}
        return o

    def cut_obj(o):
        o = dict(o)
        segs = []
        for seg in o.get("segments", []):
            s0 = int(seg.get("start_frame", 0))
            lo = max(s0, start)
            hi = min(s0 + int(seg["n_frames"]), start + n)
            if hi <= lo:
                continue
            segs.append({"start_frame": lo - start, "n_frames": hi - lo,
                         "data": {k: np.asarray(v)[lo - s0:hi - s0]
                                  for k, v in seg["data"].items()}})
        o["segments"] = segs
        return o

    out = dict(sc)
    out["metas"] = {**sc.get("metas", {}), "num_frames": n}
    out["observers"] = {k: cut_obs(v) for k, v in sc.get("observers", {}).items()}
    out["objects"] = {k: cut_obj(v) for k, v in sc.get("objects", {}).items()}
    return out


def create_scene_bank(dataset, scenebank_cfg: Dict[str, Any], exp_dir: Optional[str] = None,
                      device="cpu") -> List[Scene]:
    """The scenes of ``scenebank_cfg`` (``scenarios``: specs, default every
    scene of the dataset; ``scenario_cfg``: arguments of the dataset's
    ``get_scenario``), each scenario pickled under ``exp_dir/scenarios/``
    where ``exp_dir`` is given, each scene's tensors on ``device``."""
    specs = scenebank_cfg.get("scenarios") or dataset.scene_ids()
    scenario_kw = dict(scenebank_cfg.get("scenario_cfg", {}))
    scenes: List[Scene] = []
    for spec in specs:
        sid, start, n = parse_scene_spec(spec)
        scenario = slice_scenario(dataset.get_scenario(sid, **scenario_kw), start, n)
        if exp_dir:
            d = os.path.join(exp_dir, "scenarios")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"{sid}.pkl"), "wb") as f:
                pickle.dump(scenario, f)
        scenes.append(Scene.load_from_scenario(scenario, device=device))
    return scenes
