"""Run several tools in order on one experiment (port of
neuralsim_tpu/tools/run.py:1-46).

    python -m neuralsim_torch.tools.run train,eval,extract_mesh --config c.yaml \
        --exp_dir logs/x [--device=cpu]

The first argument names the tasks, comma-separated; the rest goes to each
task's ``main(argv)`` as it is. The tasks are the port's tools: ``train``,
``train_multi``, ``eval``, ``eval_lidar``, ``eval_multi``, ``render``,
``extract_mesh``, ``extract_occgrid``, ``extract_visible_grid``,
``manipulate`` and ``visualize_slice``. ``inspect_rendering``,
``demo_category``, ``viewer`` and ``preprocess_waymo`` are not ported (each
raises, naming itself); another name exits, listing the tasks.
"""
from __future__ import annotations

import importlib
import sys

_TASKS = {t: f"neuralsim_torch.tools.{t}" for t in (
    "train", "train_multi", "eval", "eval_lidar", "eval_multi", "render", "extract_mesh",
    "extract_occgrid", "extract_visible_grid", "manipulate", "visualize_slice")}
_NOT_PORTED = ("demo_category", "inspect_rendering", "preprocess_waymo", "viewer")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(f"usage: run <task[,task...]> [args]  — tasks: {list(_TASKS)}")
        return 1
    tasks, rest = argv[0].split(","), argv[1:]
    for t in tasks:
        if t in _NOT_PORTED:
            raise NotImplementedError(f"task {t} is not ported")
        if t not in _TASKS:
            raise SystemExit(f"unknown task {t!r}; known: {list(_TASKS)}")
        print(f"=== run: {t} ===", flush=True)
        importlib.import_module(_TASKS[t]).main(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
