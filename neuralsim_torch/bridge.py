"""Carry JAX parameters over into the port.

The JAX package keeps parameters as nested dicts and lists; the port keeps
them in modules whose parameter names follow the same paths (``layers.0.W``
for ``{"layers": [{"W": ...}]}``), with the JAX layouts, so every leaf copies
over untransposed.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn


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
