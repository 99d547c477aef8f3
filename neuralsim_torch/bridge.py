"""Carry JAX parameters and occupancy-grid state over into the port.

The JAX package keeps parameters as nested dicts and lists; the port keeps
them in modules whose parameter names follow the same paths (``layers.0.W``
for ``{"layers": [{"W": ...}]}``), with the JAX layouts, so every leaf copies
over untransposed. That holds for every field of the port: the NeuS field
(table, decoder, radiance with its appearance input, ``ln_inv_s``), the
distant field (decoder, radiance, and the 4-D LoTD's ``encoding.table``), the
sky, the appearance tables of ``ImageEmbeddings`` (``<camera>.weight``) and
EmerNeRF's field (``static_enc.table``, ``static_dec``, ``dyn_enc.table``, the
permuto table in its own layout, ``dyn_dec``, ``flow_dec``, ``radiance``) and
``LearnableParams``' pose tree ``{node: {dquat, dtrans, dintr?, dts?}}``
(``<node>.<name>``, the same [T, ...] arrays). An
occupancy grid's state is two arrays, ``val`` and
``mask`` ([R, R, R], or [G, R, R, R] for per-instance and per-keyframe grids).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from .accel import OccGridState
from .accel.occ_grid import occupied_fraction_plain


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {dotted path: array}."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@torch.no_grad()
def load_jax_params(module_or_params: Union[nn.Module, Dict[str, torch.Tensor]],
                    tree: Any) -> None:
    """Copy a JAX parameter tree (numpy leaves, e.g. from
    ``jax.tree.map(np.asarray, params)``) into a module or a dict of tensors.

    Raises on a missing or extra leaf and on any shape mismatch.
    """
    target = dict(module_or_params.named_parameters()) \
        if isinstance(module_or_params, nn.Module) else dict(module_or_params)
    src = flatten_tree(tree)
    missing = sorted(set(target) - set(src))
    extra = sorted(set(src) - set(target))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, extra {extra}")
    for name, dst in target.items():
        arr = src[name]
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: JAX shape {tuple(arr.shape)} vs port "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))


def named_jax_leaves(tree: Any, model_ids: Mapping[str, str]) -> Dict[str, np.ndarray]:
    """Name the leaves of a JAX tree keyed by role (parameters, or gradients of
    the same structure) as ``nn.ModuleDict.named_parameters()`` names the
    port's: ``model_ids`` maps each JAX top-level key to the port's model id
    (``{"cr": "Main", "sky": "Sky"}``), so a test compares leaf by leaf."""
    return flatten_tree({model_ids[k]: v for k, v in tree.items()})


def occ_state_from_numpy(val: np.ndarray, mask: np.ndarray, device="cpu") -> OccGridState:
    """An occupancy grid's state from the JAX package's ``OccGridState``
    fields as numpy arrays (``val`` float [R, R, R], ``mask`` bool)."""
    if val.shape != mask.shape or val.ndim != 3:
        raise ValueError(f"val {val.shape} and mask {mask.shape} must be equal [R, R, R]")
    return _grid_state(val, mask, device)


def grid_state_from_numpy(val: np.ndarray, mask: np.ndarray, device="cpu") -> OccGridState:
    """The state of per-instance or per-keyframe grids (``OccGridEmaBatched``,
    ``OccGridEmaDynamic``) from the JAX package's ``OccGridState`` fields as
    numpy arrays (``val`` float [G, R, R, R], ``mask`` bool)."""
    if val.shape != mask.shape or val.ndim != 4:
        raise ValueError(f"val {val.shape} and mask {mask.shape} must be equal [G, R, R, R]")
    return _grid_state(val, mask, device)


def _grid_state(val: np.ndarray, mask: np.ndarray, device) -> OccGridState:
    """The state on ``device`` with its occupied fraction (the plain mean)."""
    mask = torch.from_numpy(np.array(mask, dtype=bool)).to(device)
    return OccGridState(torch.from_numpy(np.array(val, dtype=np.float32)).to(device), mask,
                        occupied_fraction_plain(mask))
