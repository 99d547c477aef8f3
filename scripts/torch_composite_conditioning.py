#!/usr/bin/env python3
"""K6's and K12's backwards against their plain versions on ill-conditioned
edge inputs, in one or more checkouts of the port, on one card.

    python3 scripts/torch_composite_conditioning.py [ROOT ...]

Each ROOT (default: this checkout) is run in a process of its own that
imports the port from ROOT. The inputs are those of chip_smoke's edge checks
before they were conditioned: K6's alphas u^4 (a ray of one sample can have
its weight sum at the depth's 1e-8 clamp) and K12 at inv_s 300 on rays whose
surface lies anywhere between their samples (a ray whose lanes all sit on the
sigmoid's flat tails has gradients that are the last bits of 1 - P). Widths
1-1,100 at 1, 3 and 600 rays, every cotangent non-zero. Prints, a line per
root, each output whose largest error passes chip_smoke.GRAD_REL times its
largest plain entry, with that error and entry: equal lists in two checkouts
mean that the comparison, not the kernel, fails there.

The yardstick is the plain version run in float64 on the same inputs (read
from their float32 values). For every output the line gives the kernel's and
the float32 plain version's largest distance from it, over its largest
float64 entry; an output whose kernel lies further from float64 than the
float32 plain version by more than GRAD_REL times that entry (the kernels'
stated rounding) is listed under ``faults``. tests/test_torch_composite_
conditioning.py holds the JAX functions to the same yardstick on the CPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
WIDTHS = (1, 7, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 300, 1100)
RAYS = (1, 3, 600)
GRAD_REL = 1e-4  # chip_smoke.GRAD_REL
ANNEALS = (0.0, 0.5, 1.0)


def k6_inputs(n, s, seed):
    """(t, mask, alpha, rgb, nablas): alphas u^4, row 1 wholly masked, a run
    of three alpha == 1 lanes on every third row from row 2."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.random((n, s)) * 3.0, -1).astype(np.float32)
    alpha = (rng.random((n, s)) ** 4).astype(np.float32)
    mask = rng.random((n, s)) > 0.15
    run = slice(s // 3, min(s // 3 + 3, s))
    alpha[2::3, run], mask[2::3, run] = 1.0, True
    mask[1:2] = False
    return (t, mask, alpha, rng.random((n, s, 3)).astype(np.float32),
            rng.normal(size=(n, s, 3)).astype(np.float32))


def k12_inputs(n, s, seed):
    """(t, mask, sdf, nablas, rays_d, rgb) for inv_s 300: a surface at a
    depth drawn apart from the samples, row 1 wholly masked, a run of three
    alpha == 1 lanes (sdf 0.03, 0.2 before the next) every third row."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.random((n, s)) * 2.0 + 0.5, -1).astype(np.float32)
    sdf = (0.7 + rng.random((n, 1)) * 1.5 - t + rng.normal(0, 0.01, (n, s))).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    nablas = (-d[:, None, :] * (0.8 + 0.4 * rng.random((n, s, 1)))
              + rng.normal(0, 0.3, (n, s, 3))).astype(np.float32)
    mask = rng.random((n, s)) > 0.1
    mask[1:2] = False
    rows = np.arange(2, n, 3)
    for j in range(s // 3, min(s // 3 + 3, s - 1)):
        t[rows, j + 1:] += np.float32(0.2)
        sdf[rows, j], mask[rows, j] = 0.03, True
        nablas[rows, j] = -d[rows] * np.float32(1.2)
    return t, mask, sdf, nablas, d, rng.random((n, s, 3)).astype(np.float32)


def f64(xs):
    """Float64 copies of the tensors among ``xs`` that are float32."""
    import torch
    return [x.double() if isinstance(x, torch.Tensor) and x.dtype == torch.float32 else x
            for x in xs]


def yardstick(name, got, plain, exact, rel=GRAD_REL):
    """Each output's distance from float64 -> [(label, kernel err / scale,
    plain err / scale, scale, fault)]: a fault where the kernel lies further
    from float64 than the float32 plain version by more than rel x scale."""
    rows = []
    for i, (g, p, w) in enumerate(zip(got, plain, exact)):
        if w is None:
            continue
        scale = float(w.abs().max())
        ek, ep = float((g.double() - w).abs().max()), float((p.double() - w).abs().max())
        s = scale if scale > 0 else 1.0
        rows.append((f"{name} output {i}", ek / s, ep / s, scale, not ek <= ep + rel * s))
    return rows


def run_root(root: str) -> dict:
    import torch
    from neuralsim_torch import kernels
    from neuralsim_torch.renderers.buffers import volume_composite_bwd, volume_composite_bwd_plain
    from neuralsim_torch.renderers.neus_composite import (neus_composite_bwd,
                                                          neus_composite_bwd_plain)
    if not torch.cuda.is_available():
        raise SystemExit("torch_composite_conditioning: CUDA is not available")
    if Path(kernels.__file__).resolve().parents[1] != Path(root).resolve():
        raise SystemExit(f"torch_composite_conditioning: imported the port from {kernels.__file__}")
    dev = torch.device("cuda")
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cot = lambda shape, seed: T(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    inv_s = torch.tensor(300.0, device=dev)
    past, rows = [], []

    def hold(name, got, want, exact):
        flagged = []
        for i, (g, w) in enumerate(zip(got, want)):
            if w is None:
                continue
            e, scale = float((g - w).abs().max()), float(w.abs().max())
            if not e <= GRAD_REL * scale:
                past.append(f"{name} output {i}: err {e:.3g}, largest {scale:.3g}")
                flagged.append(f"{name} output {i}")
        for r in yardstick(name, got, want, exact):
            rows.append((*r, r[0] in flagged))

    for s in WIDTHS:
        for n in RAYS:
            seed = 1000 * s + n
            a = [T(v) for v in k6_inputs(n, s, seed)]
            c = [cot(sh, seed + i) for i, sh in enumerate(((n, s), (n,), (n,), (n, 3), (n, 3)))]
            hold(f"K6 bwd rays={n} S={s}", volume_composite_bwd(*a, *c),
                 volume_composite_bwd_plain(*a, *c),
                 volume_composite_bwd_plain(*f64(a), *f64(c)))
            t, mask, sdf, nablas, d, rgb = (T(v) for v in k12_inputs(n, s, seed))
            anneal = ANNEALS[seed % 3]
            for with_rgb in (True, False):
                a = (t, mask, sdf, nablas, d, anneal, inv_s, rgb if with_rgb else None)
                c = [cot(sh, seed + 10 + i) for i, sh in enumerate(
                    ((n, s), (n,), (n,), (n, 3), (n, 3), (n, s)))]
                if not with_rgb:
                    c[3] = None
                hold(f"K12 bwd rays={n} S={s} anneal={anneal:g} rgb={with_rgb}",
                     neus_composite_bwd(*a, *c), neus_composite_bwd_plain(*a, *c),
                     neus_composite_bwd_plain(*f64(a), *f64(c)))
    torch.cuda.synchronize()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    worst = lambda k: max(rows, key=lambda r: r[k])
    return {"root": root, "past_grad_rel": past, "outputs": len(rows),
            "faults": [r[:4] for r in rows if r[4]],
            # the outputs past GRAD_REL against the float32 plain version:
            # (label, kernel err, plain err over the largest float64 entry, it)
            "past_grad_rel_from_f64": [r[:4] for r in rows if r[5]],
            "worst_kernel_from_f64": worst(1)[:4], "worst_plain_from_f64": worst(2)[:4],
            "card": card}


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(run_root(argv[1])), flush=True)
        return 0
    rc = 0
    for root in [str(Path(r).resolve()) for r in argv] or [str(HERE)]:
        env = {**os.environ, "PYTHONPATH": root}  # the child imports the port from root
        p = subprocess.run([sys.executable, __file__, "--one", root], cwd=root, env=env,
                           capture_output=True, text=True, timeout=1200)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            print(f"torch_composite_conditioning: {root} exited {p.returncode}", file=sys.stderr)
            rc = 1
            continue
        print(p.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
