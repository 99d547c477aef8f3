"""The port's checkpoints and its training and evaluation drivers, on the CPU
and on the port alone (the JAX package's checkpoints are orbax trees of
other arrays): ``utils.checkpoint.CheckpointIO`` and the loop state of
``tools.train_multi``, ``train_multi.main_function`` with ``resume_dir``,
and the exp dir that ``main_function`` of train_multi, eval_multi and
eval_lidar write.

Small size: test_torch_multi_train.py's SMALL (2 vehicles, 3 frames of
32x48, narrow encodings, a 16^3 street grid refreshed every 2nd step, 64
pixel rays and 48 beams an iteration), with the street's road pretrain at 200
steps of 1,024 points so that the LiDAR beams hit it. No tolerance: a
checkpoint holds every tensor bit for bit, and a run resumed from one takes
the steps of an unbroken run bit for bit (the CPU's plain versions are
deterministic at one thread).
"""
import copy
import csv
import json
import os
import pickle

import numpy as np
import pytest
import torch

from chip_smoke import state_tensors
from neuralsim_torch.tools import eval_lidar, eval_multi
from neuralsim_torch.tools.build import build_multi_trainer
from neuralsim_torch.tools.train_multi import (loop_state, main_function, restore_loop,
                                               train_loop)
from neuralsim_torch.utils.checkpoint import STATE_FILE, CheckpointIO
from test_torch_multi_train import SMALL

torch.set_num_threads(1)

CFG = copy.deepcopy(SMALL)
CFG["assetbank_cfg"]["Street"]["model_params"]["pretrain"].update(n_iters=200, n_pts=1024)
CFG["training"]["i_log"] = 1
PNG = b"\x89PNG\r\n\x1a\n"


def _cfg(exp, n, **kw):
    return {**copy.deepcopy(CFG), "exp_dir": str(exp),
            "training": {**CFG["training"], "num_iters": n}, **kw}


def _assert_bit_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert set(ta) == set(tb)
    for k, v in ta.items():
        assert v.dtype == tb[k].dtype and torch.equal(v, tb[k]), k


@pytest.fixture(scope="module")
def trained():
    scene, bank, trainer, state, samplers = build_multi_trainer(CFG, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = train_loop(scene, trainer, state, samplers, 3, gen, i_log=100)
    return trainer, state, samplers, gen


def test_checkpoint_round_trip_is_bit_equal(trained, tmp_path):
    trainer, state, samplers, gen = trained
    ckpt = CheckpointIO(str(tmp_path), loop=lambda: loop_state(gen, samplers))
    path = ckpt.save(state, state.it, tag="final")
    assert os.path.isfile(os.path.join(path, STATE_FILE))
    assert state.occ["cr"].frac is not None and state.it == 3
    _, _, _, fresh, fresh_samplers = build_multi_trainer(CFG, device="cpu", pretrain=False)
    restored, loop = CheckpointIO(str(tmp_path)).load(fresh)
    assert restored is fresh
    _assert_bit_equal(state, fresh)
    gen2 = torch.Generator().manual_seed(123)
    restore_loop(loop, gen2, fresh_samplers)
    assert torch.equal(gen2.get_state(), gen.get_state())
    for name in ("pixel", "lidar"):
        assert fresh_samplers[name].rng.bit_generator.state == \
            samplers[name].rng.bit_generator.state
    imp, imp2 = samplers["imp"], fresh_samplers["imp"]
    assert imp2.it == imp.it > 0 and set(imp2.maps) == set(imp.maps)
    for cam, m in imp.maps.items():
        np.testing.assert_array_equal(imp2.maps[cam].map, m.map)


def test_loading_refuses_another_model(trained, tmp_path):
    trainer, state, _, _ = trained
    CheckpointIO(str(tmp_path)).save(state, 3, tag="final")
    other = copy.deepcopy(CFG)
    other["assetbank_cfg"]["Street"]["model_params"]["accel_cfg"]["resolution"] = 8
    _, _, _, fresh, _ = build_multi_trainer(other, device="cpu", pretrain=False)
    with pytest.raises(ValueError, match="grid cr"):
        CheckpointIO(str(tmp_path)).load(fresh)
    assert CheckpointIO(str(tmp_path / "empty")).load(fresh) is None


def test_step_checkpoints_are_collected_and_the_newest_is_loaded(trained, tmp_path):
    trainer, state, _, _ = trained
    ckpt = CheckpointIO(str(tmp_path), i_backup=4, keep_last=2, i_save_seconds=1e9)
    for step in range(1, 10):
        assert (ckpt.maybe_save(state, step) is not None) == (step % 4 == 0)
        ckpt.save(state, step)
    assert [os.path.basename(p) for p in ckpt.sorted_ckpts()] == \
        ["step_00000004", "step_00000008", "step_00000009"]
    final = ckpt.save(state, 9, tag="final")
    latest = ckpt.save(state, 9, tag="latest")
    for first, second in ((final, latest), (latest, final)):
        os.utime(os.path.join(first, STATE_FILE), (1e9, 1e9))
        os.utime(os.path.join(second, STATE_FILE), (2e9, 2e9))
        assert ckpt.newest() == second
    os.utime(os.path.join(ckpt.sorted_ckpts()[-1], STATE_FILE), (3e9, 3e9))
    assert ckpt.newest().endswith("step_00000009")
    ckpt.i_save_seconds = -1.0
    assert ckpt.maybe_save(state, 10) == latest


def test_resumed_run_equals_an_unbroken_one(tmp_path):
    """4 iterations straight, against 2, a save, and a fresh build from
    ``resume_dir`` that runs iterations 2 and 3: the same losses at every
    logged iteration and the same final state, bit for bit."""
    whole = main_function(_cfg(tmp_path / "whole", 4), device="cpu")
    main_function(_cfg(tmp_path / "part", 2), device="cpu")
    resumed = main_function(_cfg(tmp_path / "resumed", 4, resume_dir=str(tmp_path / "part")),
                            device="cpu")
    assert [r["it"] for r in resumed["log"]] == [2, 3]
    assert resumed["log"] == whole["log"][2:]
    _assert_bit_equal(whole["state"], resumed["state"])
    assert resumed["skips_total"] == whole["skips_total"] == 0


def test_the_drivers_write_the_jax_tools_files(tmp_path):
    """train_multi, eval_multi and eval_lidar at 3 iterations: the JAX tools'
    file names and keys (the config as JSON, ``config.json``, where the JAX
    package writes YAML)."""
    exp = tmp_path / "exp"
    out = main_function(_cfg(exp, 3), device="cpu")
    assert out["exp_dir"] == str(exp) and out["skips_total"] == 0 and len(out["iter_s"]) == 3
    assert {"config.json", "metrics.jsonl", "stats.p", "ckpts"} <= set(os.listdir(exp))
    assert os.listdir(exp / "ckpts") == ["final"]
    with open(exp / "config.json") as f:
        cfg = json.load(f)
    assert cfg["training"]["num_iters"] == 3
    with open(exp / "stats.p", "rb") as f:
        stats = pickle.load(f)
    assert [s for s, _ in stats["loss_total"]] == [0, 1, 2] and "lidar/loss_lidar" in stats
    assert all("step" in json.loads(line) for line in open(exp / "metrics.jsonl"))

    ev = eval_multi.main_function({**cfg, "resume_dir": str(exp),
                                   "eval": {"frames": "0,2", "rayschunk": 512}}, device="cpu")
    with open(exp / "eval_multi" / "metrics.json") as f:
        metrics = json.load(f)
    assert set(metrics) == {"per_frame", "per_object", "per_class", "mean"} and metrics == \
        json.loads(json.dumps(ev))
    assert set(metrics["mean"]) == {"psnr", "ssim", "lpips", "psnr_fg", "psnr_bg", "mask_bce",
                                    "mask_acc"}
    assert set(metrics["per_class"]) == {"Vehicle", "street", "distant"}
    with open(exp / "eval_multi" / "per_object.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2 * 4 and list(rows[0]) == sorted(rows[0])
    assert {"road_vis_mass", "road_dominant_frac", "vis_mass"} <= set(rows[0])
    pngs = sorted(p for p in os.listdir(exp / "eval_multi") if p.endswith(".png"))
    assert pngs == ["depth_0000.png", "gt_0000.png", "obj_distant_0000.png",
                    "obj_street_0000.png", "obj_veh_0_0000.png", "obj_veh_1_0000.png",
                    "rgb_0000.png"]
    for p in pngs:
        data = (exp / "eval_multi" / p).read_bytes()
        assert data.startswith(PNG) and int.from_bytes(data[16:20], "big") == 48

    lo = eval_lidar.main_function({**cfg, "resume_dir": str(exp),
                                   "renderer": {**cfg["renderer"], "type": "multi"},
                                   "eval": {"frames": [0, 2]}}, device="cpu")
    with open(exp / "eval" / "lidar_metrics.json") as f:
        assert json.load(f) == json.loads(json.dumps(lo))
    assert len(lo["per_frame"]) == 2 and {"mae", "rmse", "hit_recall", "chamfer",
                                          "chamfer_95", "chamfer_gt_99"} <= set(lo["mean"])


def test_the_drivers_refuse_what_is_not_ported(tmp_path):
    for name, val in (("nan_debug", True), ("profile_iters", 10)):
        with pytest.raises(NotImplementedError, match=name):
            main_function(_cfg(tmp_path, 1, training={**CFG["training"], name: val}),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="single-scene"):
        eval_lidar.main_function(_cfg(tmp_path, 1), device="cpu")


def test_a_window_of_skipped_steps_saves_nan_debug_and_stops(tmp_path):
    scene, bank, trainer, state, samplers = build_multi_trainer(CFG, device="cpu")
    loader = samplers["pixel"].loader
    for key in loader.images:
        loader.images[key] = np.full_like(loader.images[key], np.nan)
    ckpt = CheckpointIO(str(tmp_path))
    with pytest.raises(FloatingPointError, match="every step"):
        train_loop(scene, trainer, state, samplers, 3, torch.Generator().manual_seed(0),
                   i_log=1, ckpt=ckpt)
    assert os.path.isfile(tmp_path / "nan_debug" / STATE_FILE)
    assert int(torch.load(tmp_path / "nan_debug" / STATE_FILE, weights_only=True)["skips"]) == 2
