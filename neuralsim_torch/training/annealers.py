"""Scalar schedules ("annealers") that drive loss weights and learning rates
(port of neuralsim_tpu/training/annealers.py).

The iteration index is a host number in the port (PyTorch runs eagerly, so a
schedule needs no traced scalar), and every schedule returns a Python float.

Config shape::

    {type: linear,      start_it, stop_it, start_val, stop_val}
    {type: exponential, start_it, stop_it, start_val, stop_val}
    {type: milestones,  milestones: [it0, it1, ...], vals: [v0, v1, ..., vK]}
    {type: constant,    val}
    {type: mix_linear,  start_it, stop_it}      # the mixing fraction in [0, 1]
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence


def _frac(it: float, start_it: float, stop_it: float) -> float:
    return min(max((it - start_it) / max(stop_it - start_it, 1e-9), 0.0), 1.0)


def _linear(it, start_it, stop_it, start_val, stop_val) -> float:
    return start_val + (stop_val - start_val) * _frac(it, start_it, stop_it)


def _exponential(it, start_it, stop_it, start_val, stop_val) -> float:
    return math.exp(math.log(start_val) + (math.log(stop_val) - math.log(start_val))
                    * _frac(it, start_it, stop_it))


def _milestones(it, milestones: Sequence[float], vals: Sequence[float]) -> float:
    idx = sum(1 for m in milestones if it >= m)
    return float(vals[min(idx, len(vals) - 1)])


def get_anneal_val(it: float, **cfg: Any) -> float:
    """Evaluate a schedule config at iteration ``it``."""
    typ = cfg.get("type", "constant")
    if typ == "constant":
        return float(cfg.get("val", cfg.get("w", 1.0)))
    if typ == "linear":
        return _linear(it, cfg.get("start_it", 0), cfg["stop_it"],
                       cfg.get("start_val", 0.0), cfg.get("stop_val", 1.0))
    if typ == "exponential":
        return _exponential(it, cfg.get("start_it", 0), cfg["stop_it"],
                            cfg.get("start_val", 1e-3), cfg.get("stop_val", 1.0))
    if typ == "milestones":
        return _milestones(it, cfg["milestones"], cfg["vals"])
    if typ == "mix_linear":
        return _linear(it, cfg.get("start_it", 0), cfg["stop_it"], 0.0, 1.0)
    raise ValueError(f"Unknown annealer type: {typ}")


def make_annealer(cfg: Dict[str, Any]) -> Callable[[float], float]:
    """Bind a schedule config into a callable ``it -> value``."""
    cfg = dict(cfg)
    return lambda it: get_anneal_val(it, **cfg)
