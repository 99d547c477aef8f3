"""Checkpoints of a training run (port of neuralsim_tpu/utils/checkpoint.py,
with ``torch.save`` in place of orbax).

A checkpoint is a directory under ``ckpt_dir`` named by its tag (``final``,
``latest``, ``nan_debug``) or its step (``step_00005000``), holding one file,
``state.pt``, written whole before it replaces the old one. It keeps the
whole :class:`~neuralsim_torch.training.trainer.TrainState`: every parameter
and buffer of the models, each model's Adam moments and step count, ``it``,
``skips`` and every occupancy grid's state (values, mask and occupied
fraction), plus, where the caller gives ``loop``, the training loop's own
state (its random generators and the error maps), so that a resumed run
takes the steps an unbroken one would. ``load`` copies a checkpoint into a
state built from the same config, on any device.
"""
from __future__ import annotations

import os
import re
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..accel import OccGridState
from ..training.trainer import TrainState

STATE_FILE = "state.pt"


def state_dict(state: TrainState) -> Dict[str, Any]:
    """The tensors and numbers of ``state`` as a tree of plain containers."""
    return {"params": state.params.state_dict(),
            "opt": {mid: opt.state_dict() for mid, opt in state.opt.items()},
            "it": int(state.it), "skips": state.skips,
            "occ": None if state.occ is None else
            {role: {"val": st.val, "mask": st.mask, "frac": st.frac}
             for role, st in state.occ.items()}}


@torch.no_grad()
def load_state_dict(state: TrainState, sd: Dict[str, Any]) -> TrainState:
    """Copy a :func:`state_dict` into ``state`` (its parameters and moments
    in place, onto their devices); raises where the two differ in models,
    parameters, shapes or grids."""
    state.params.load_state_dict(sd["params"])
    if set(sd["opt"]) != set(state.opt):
        raise ValueError(f"the checkpoint's optimizers {sorted(sd['opt'])} are not the "
                         f"state's {sorted(state.opt)}")
    for mid, opt in state.opt.items():
        opt.load_state_dict(sd["opt"][mid])
    dev = state.skips.device
    state.it = int(sd["it"])
    state.skips = sd["skips"].to(device=dev, dtype=torch.int32).clone()
    if (sd["occ"] is None) != (state.occ is None) or \
            set(sd["occ"] or {}) != set(state.occ or {}):
        raise ValueError("the checkpoint's occupancy grids are not the state's")
    for role, st in (sd["occ"] or {}).items():
        if tuple(st["val"].shape) != tuple(state.occ[role].val.shape):
            raise ValueError(f"grid {role}: {tuple(st['val'].shape)} in the checkpoint, "
                             f"{tuple(state.occ[role].val.shape)} in the state")
        state.occ[role] = OccGridState(st["val"].to(dev).clone(), st["mask"].to(dev).clone(),
                                       None if st["frac"] is None else
                                       st["frac"].to(dev).clone())
    return state


class CheckpointIO:
    """Saves and finds the checkpoints of one run: ``maybe_save`` writes
    ``latest`` when ``i_save_seconds`` have passed since the last such save
    and ``step_N`` every ``i_backup`` steps; of the step checkpoints the
    last ``keep_last`` stay, and those of the ``i_backup`` cadence.
    ``loop``, where given, returns the training loop's state at each save."""

    def __init__(self, ckpt_dir: str, *, i_save_seconds: float = 900.0, i_backup: int = 5000,
                 keep_last: int = 3, loop: Optional[Callable[[], Dict[str, Any]]] = None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.i_save_seconds = i_save_seconds
        self.i_backup = i_backup
        self.keep_last = keep_last
        self.loop = loop
        self._last_save_t = time.time()

    def save(self, state: TrainState, step: int, tag: Optional[str] = None) -> str:
        """Write ``state`` under ``tag`` (default ``step_%08d``), replacing a
        checkpoint of that name; returns its directory."""
        path = os.path.join(self.ckpt_dir, tag or f"step_{step:08d}")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({**state_dict(state), "step": int(step),
                    "loop": None if self.loop is None else self.loop()},
                   os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        self._gc()
        return path

    def newest(self) -> Optional[str]:
        """The most recently written of the newest step checkpoint, ``final``
        and ``latest``, or None."""
        candidates = self.sorted_ckpts()[-1:] + [
            p for p in (os.path.join(self.ckpt_dir, t) for t in ("final", "latest"))
            if os.path.isfile(os.path.join(p, STATE_FILE))]
        if not candidates:
            return None
        return max(candidates, key=lambda p: os.path.getmtime(os.path.join(p, STATE_FILE)))

    def load(self, state: TrainState, tag_or_path: Optional[str] = None
             ) -> Optional[Tuple[TrainState, Optional[Dict[str, Any]]]]:
        """Copy a checkpoint into ``state`` (built from the run's config, on
        any device): ``tag_or_path`` (a tag or step directory name here, or a
        path), by default :meth:`newest`. Returns (state, the loop's state or
        None), or None where there is no checkpoint."""
        path = self.newest() if tag_or_path is None else tag_or_path
        if path is None:
            return None
        if not os.path.isabs(path):
            path = os.path.join(self.ckpt_dir, path)
        sd = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
        return load_state_dict(state, sd), sd.get("loop")

    def sorted_ckpts(self) -> List[str]:
        """The step checkpoints' directories, by step."""
        out = []
        for d in os.listdir(self.ckpt_dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.isfile(os.path.join(self.ckpt_dir, d, STATE_FILE)):
                out.append((int(m.group(1)), os.path.join(self.ckpt_dir, d)))
        return [p for _, p in sorted(out)]

    def _gc(self) -> None:
        for p in self.sorted_ckpts()[:-self.keep_last] if self.keep_last else []:
            step = int(re.search(r"step_(\d+)$", p).group(1))
            if not (self.i_backup and step % self.i_backup == 0):
                shutil.rmtree(p, ignore_errors=True)

    def maybe_save(self, state: TrainState, step: int) -> Optional[str]:
        """After step ``step``: ``step_N`` on the ``i_backup`` cadence, and
        ``latest`` once ``i_save_seconds`` have passed since the last."""
        saved = None
        if self.i_backup and step > 0 and step % self.i_backup == 0:
            saved = self.save(state, step)
        if time.time() - self._last_save_t > self.i_save_seconds:
            saved = self.save(state, step, tag="latest")
            self._last_save_t = time.time()
        return saved
