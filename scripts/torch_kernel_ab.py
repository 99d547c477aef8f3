#!/usr/bin/env python3
"""Time the redesigned kernels at the multi-object shapes in one or more
checkouts of the port, in turns, on one card.

    python3 scripts/torch_kernel_ab.py [ROOT ...]

Each ROOT (default: this checkout) holds ``neuralsim_torch/`` and
``chip_smoke.py``. Each is timed in a process of its own, which builds that
checkout's kernels, in the order given: "PARENT . . PARENT" compares two
checkouts on one card (parent, change, change, parent). The shapes are the
multi-object iteration's (WAYMO_DEMO_MULTI): K5b at the street's stages (32
and 40 samples + 8 draws at 4,096 pixel rays and 2,048 beams) and the
vehicles' (24 + 8 at 6,144 compacted rows), synthetic_object's render stage
(80 + 16 at 4,096 rays) and the bench model's (24 + 8 at 8,192), beside a
stable torch.sort of the keys; K3's backward at the vehicles' final query (3 x 2,048 rows x 32
samples, two dense levels of F 4), at their uniform eikonal (512 points), with
every point in one cell, and at synthetic_object's two hash levels (2,048
rays x 96 samples); K1's backward at the street's pixel and LiDAR steps, the
vehicles' final query and each model's uniform eikonal (512 points); K2's
backward (NEURALSIM_CP_STACKED=0) at the same five launches and the bench
ladder's (8,192 rays x 32 samples); where K3's backward takes a plan, its
private and atomics paths each forced at 512, 32,768 and 196,608 of the
vehicles' points.
Every root is timed by this checkout's chip_smoke.py: "ms", CUDA events over
20 calls back to back (``cuda_ms``: the host's pace where it is the slower);
"queued_ms", the same while the card was held busy as the host queued them;
"prof_ms", the device time of the call's kernels under torch.profiler, a
call; "host_ms", the host's time a call. Prints one JSON line per root, with
the card's name and power limit.
"""
from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def timer():
    """This checkout's chip_smoke.py, whatever the root being timed."""
    spec = importlib.util.spec_from_file_location("ab_timing", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cp_launches(cs, street, veh):
    """K1's and K2's launches in a multi-object iteration: each model's final
    query (the street's at a pixel and a LiDAR step) and uniform eikonal ->
    [(label, encoding, points)]."""
    return [("street, pixel step", street, cs.ray_points(4096, 48, street.cp_rmax, 30)),
            ("street, LiDAR step", street, cs.ray_points(2048, 48, street.cp_rmax, 30)),
            ("vehicles", veh, cs.ray_points(6144, 32, veh.cp_rmax, 30)),
            ("street, uniform eikonal", street, cs.enc_points(512, street.cp_rmax, 34)),
            ("vehicles, uniform eikonal", veh, cs.enc_points(512, veh.cp_rmax, 34))]


def time_root(root: str) -> dict:
    tm = timer()
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from neuralsim_torch import kernels
    from neuralsim_torch.configs import BENCH_OBJECT, SYNTHETIC_OBJECT, WAYMO_DEMO_MULTI
    from neuralsim_torch.fields.conditional import ConditionalLoTDNeuSField
    from neuralsim_torch.fields.encodings import lotd
    from neuralsim_torch.ops.segment import merge_sorted_samples

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: CUDA is not available")
    if Path(kernels.__file__).resolve().parents[1] != Path(root).resolve():
        raise SystemExit(f"torch_kernel_ab: imported the port from {kernels.__file__}")
    kernels.library()
    dev = torch.device("cuda")
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    planned = "plan" in inspect.signature(lotd.lotd_grid_bwd).parameters
    out = {"root": root, "k3_bwd_takes_a_plan": planned}

    def timed(fn, prefix=""):
        return {prefix + "ms": tm.cuda_ms(fn), prefix + "queued_ms": tm.cuda_ms(fn, queued=True),
                prefix + "prof_ms": tm.prof_ms(fn), prefix + "host_ms": tm.host_ms(fn)}

    for n, a, b in ((4096, 32, 8), (4096, 40, 8), (2048, 32, 8), (2048, 40, 8), (6144, 24, 8),
                    (4096, 80, 16), (8192, 24, 8)):
        ins = [T(v) for v in cs.merge_inputs(n, a, b, 3)]
        keys = torch.cat([ins[0], ins[1]], -1)
        out[f"K5b {n} {a}+{b}"] = {
            **timed(lambda: merge_sorted_samples(*ins)),
            **timed(lambda: torch.sort(keys, dim=-1, stable=True), "library_")}

    mp = WAYMO_DEMO_MULTI["assetbank_cfg"]
    veh = ConditionalLoTDNeuSField(
        n_instances=3, encoding_cfg=mp["Vehicle"]["model_params"]["encoding_cfg"]).encoding
    street = lotd.make_lotd(mp["Street"]["model_params"]["encoding_cfg"])
    obj = lotd.make_lotd(SYNTHETIC_OBJECT["assetbank_cfg"]["Main"]["model_params"]["encoding_cfg"])
    for e in (veh, street, obj):
        e.reset_parameters(torch.Generator().manual_seed(0))
    veh, street, obj = veh.to(dev), street.to(dev), obj.to(dev)
    rng = np.random.default_rng(8)
    k3_sets = (("vehicles' final query", veh, cs.ray_points(6144, 32, veh.cp_rmax, 30)),
               ("vehicles' uniform eikonal", veh, cs.enc_points(512, veh.cp_rmax, 34)),
               ("vehicles, one cell", veh,
                (0.3 + 1e-3 * rng.random((6144 * 32, 3))).astype(np.float32)),
               ("synthetic_object hash levels", obj, cs.ray_points(2048, 96, obj.cp_rmax, 6)))
    for label, e, pts in k3_sets:
        x = T(pts)
        N, C = x.shape[0], e.out_dim
        args = (e.table.numel(), x, e._grid_meta, cs.cotangents((C, N), 31, dev),
                cs.cotangents((3, C, N), 32, dev))
        kw = {"plan": lotd.grid_bwd_plan(e._grid_meta.tolist()).at(N)} if planned else {}
        out[f"K3 bwd {label} N={N}"] = timed(lambda: lotd.lotd_grid_bwd(*args, **kw))
    if planned:  # K3 bwd's two paths, each forced, on the vehicles' dense levels
        for n_rays in (16, 1024, 6144):
            x = T(cs.ray_points(n_rays, 32, veh.cp_rmax, 36))
            N, C = x.shape[0], veh.out_dim
            args = (veh.table.numel(), x, veh._grid_meta, cs.cotangents((C, N), 31, dev),
                    cs.cotangents((3, C, N), 32, dev))
            for path, plan in (("private", veh.grid_bwd_plan), ("atomics", lotd.GridBwdPlan(0, 0))):
                out[f"K3 bwd vehicles N={N} {path} path"] = timed(
                    lambda: lotd.lotd_grid_bwd(*args, plan=plan))
    for label, e, pts in cp_launches(cs, street, veh):
        x = T(pts)
        N, C = x.shape[0], e.out_dim
        lines = e.cp_stacked_lines().detach().to(torch.bfloat16)
        args = (lines, x, e._cp_rows, cs.cotangents((C, N), 31, dev),
                cs.cotangents((3, C, N), 32, dev))
        out[f"K1 bwd {label} N={N} F={lines.shape[1]} R={lines.shape[2]}"] = timed(
            lambda: lotd.lotd_cp_stacked_bwd(*args))
    with tm.cp_per_level():
        veh_l = ConditionalLoTDNeuSField(
            n_instances=3, encoding_cfg=mp["Vehicle"]["model_params"]["encoding_cfg"]).encoding
        street_l = lotd.make_lotd(mp["Street"]["model_params"]["encoding_cfg"])
        bench_l = lotd.make_lotd(BENCH_OBJECT["models"]["cr"]["params"]["encoding_cfg"])
    for e in (veh_l, street_l, bench_l):
        e.reset_parameters(torch.Generator().manual_seed(0))
    veh_l, street_l, bench_l = veh_l.to(dev), street_l.to(dev), bench_l.to(dev)
    for label, e, pts in cp_launches(cs, street_l, veh_l) + [
            ("bench ladder", bench_l, cs.ray_points(8192, 32, 1024, 30))]:
        x = T(pts)
        N, C = x.shape[0], e.out_dim
        args = (e.table.detach(), x, e._cp_meta, cs.cotangents((C, N), 31, dev),
                cs.cotangents((3, C, N), 32, dev))
        out[f"K2 bwd {label} N={N} levels={e._cp_meta.shape[0]}"] = timed(
            lambda: lotd.lotd_cp_level_bwd(*args))
    torch.cuda.synchronize()
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60).stdout.strip()
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(time_root(argv[1])), flush=True)
        return 0
    roots = [str(Path(r).resolve()) for r in argv] or [str(HERE)]
    rc = 0
    for root in roots:
        # the child imports the port from ``root``, never from this checkout
        env = {**os.environ, "PYTHONPATH": root}
        p = subprocess.run([sys.executable, __file__, "--one", root], cwd=root, env=env,
                           capture_output=True, text=True, timeout=1200)
        sys.stderr.write(p.stderr[-4000:])
        if p.returncode != 0:
            print(f"torch_kernel_ab: {root} exited {p.returncode}", file=sys.stderr)
            rc = 1
            continue
        print(p.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
