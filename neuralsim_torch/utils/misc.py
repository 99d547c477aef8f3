"""Small helpers of the tools (port of neuralsim_tpu/utils/misc.py:129-141)."""
from __future__ import annotations

from typing import Iterable


def set_eval_iteration(fields: Iterable, it) -> None:
    """Stamp a checkpoint's training iteration ``it`` on each field as
    ``eval_it``, so that the schedules a render reads without an iteration
    (the NeuS inv_s mix, ``NeuSField.forward_inv_s``) take the value that
    checkpoint reached, not the completed anneal's. Fields without such a
    schedule ignore it; None entries are skipped."""
    for f in fields:
        if f is not None:
            f.eval_it = int(it)
