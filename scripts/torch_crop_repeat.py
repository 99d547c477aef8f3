#!/usr/bin/env python3
"""Repeat chip_smoke.py's card-vs-CPU crop check of the bench model over
several trained states (PyTorch port, one NVIDIA GPU).

    python3 scripts/torch_crop_repeat.py [N_STATES=10]

K1's backward sums with atomics, so 48 training steps from one seed end in a
state that differs from run to run, and with it the rays on which the card
places a sample elsewhere than the CPU path. Each repetition builds
``build_trainer(BENCH_OBJECT)``, trains chip_smoke's 48 steps and runs
``chip_smoke.check_crop_by_ray`` on the centre crop of each of the four
frames; the script prints every result, then the largest and smallest of each
number over all crops and how many crops failed. The limits in chip_smoke.py
(EQUAL_DEPTH_TOL, CROP_MOVED_MAX, OTHER_MEAN_TOL, OTHER_OFF_MAX) are set from
this spread. Exits non-zero if a crop failed.
"""
from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv) -> int:
    import torch
    import chip_smoke as cs
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import BENCH_OBJECT
    from neuralsim_torch.dataio.synthetic import SyntheticObjectDataset
    from neuralsim_torch.tools.build import build_trainer

    if not torch.cuda.is_available():
        print("torch_crop_repeat: CUDA is not available", file=sys.stderr)
        return 1
    n_states = int(argv[0]) if argv else 10
    dev = torch.device("cuda")
    kernels.build()
    kernels.library()
    rig = SyntheticObjectDataset(**BENCH_OBJECT["dataset_cfg"]["params"])
    results, failed = [], 0
    for rep in range(n_states):
        trainer, state = build_trainer(BENCH_OBJECT)
        cs.bench_steps(trainer, state, rig, dev)
        for fi in cs.BENCH_FRAME_IDS:
            o, d = cs.frame_rays(rig, fi, "cpu", cs.crop_slices(rig.H, rig.W))
            try:
                res = cs.check_crop_by_ray(trainer.renderer, state.params, o, d, dev,
                                           state.occ, cs.occ_on(state, "cpu"))
            except AssertionError as e:
                failed += 1
                cs.log(f"state {rep} frame {fi}: FAILED: {e}")
                continue
            results.append(res)
            cs.log(f"state {rep} frame {fi}: {res}")
    for k in (results[0] if results else ()):
        cs.log(f"{k}: max {max(r[k] for r in results):.6g}, min {min(r[k] for r in results):.6g}")
    cs.log(f"{failed} of {len(results) + failed} crops failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
