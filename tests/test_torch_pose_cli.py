"""Pose refinement from the command line: configs/waymo_emernerf.yaml as
written plus the dot overrides that add a ``Pose`` asset (``LearnableParams``
refining the ego car and the front camera, the camera's intrinsics; its own
lr), on the demo drive written to disk (3 frames of 16x24), on the CPU at
narrow widths (tests/test_torch_emernerf_cli.py's ``NARROW_ARGV``).

``tools.train.main`` binds the asset as the trainer's pose model (its
``enable_after``), trains the deltas (zero before the gate, moved after it),
keeps them in the checkpoint: a fresh build loads them bit-equal, and a run
cut after 2 iterations and resumed to 3 ends with the bits of an unbroken run
of 3 (the Street's schedule pinned to 3 steps in both). Timestamp mode
(``refine_ts``, ``training.use_ts_interp``) trains the camera's ``dts``. The
evaluation and replay of such an exp dir apply no deltas, as JAX's tools.
Multi-object training refuses pose refinement (and ``use_ts_interp``), by
name.
"""
import math
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_emernerf_cli import NARROW_ARGV  # noqa: E402

from neuralsim_torch.config import load_config  # noqa: E402
from neuralsim_torch.dataio.waymo_demo import build_demo_sequence  # noqa: E402
from neuralsim_torch.models.assets import LearnableParams  # noqa: E402
from neuralsim_torch.tools import eval as single_eval  # noqa: E402
from neuralsim_torch.tools import render, train, train_multi  # noqa: E402
from neuralsim_torch.tools.build import build_everything, build_multi_trainer  # noqa: E402
from neuralsim_torch.training.multi_trainer import MultiObjectTrainer  # noqa: E402
from neuralsim_torch.utils.checkpoint import CheckpointIO  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "waymo_emernerf.yaml")
MULTI_YAML = os.path.join(ROOT, "configs", "waymo_demo_multi.yaml")
POSE_ARGV = [
    "--assetbank_cfg.Pose.model_class=neuralsim_tpu.models.assets.LearnableParams",
    "--assetbank_cfg.Pose.model_params.refine_nodes=[ego_car,camera_FRONT]",
    "--assetbank_cfg.Pose.model_params.refine_intr=[camera_FRONT]",
    "--assetbank_cfg.Pose.asset_params.training_cfg.lr=0.001"]
TS_ARGV = ["--assetbank_cfg.Pose.model_params.refine_ts=[camera_FRONT]",
           "--training.use_ts_interp=true"]
# the Street's schedule decays over ${training.num_iters}: pinned, so that a
# run of 2 resumed to 3 takes the steps of a run of 3
PINNED = ["--assetbank_cfg.Street.asset_params.training_cfg.total_steps=3",
          "--assetbank_cfg.Pose.model_params.enable_after=1"]


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("waymo"))
    build_demo_sequence(d, n_frames=3, H=16, W=24)
    return d


def _train(drive, exp, *extra):
    return train.main(["--config", YAML, f"--exp_dir={exp}", f"--dataset_cfg.params.root={drive}",
                       "--device=cpu"] + NARROW_ARGV + POSE_ARGV + list(extra))


def _deltas(state):
    return {k: v.detach().clone() for k, v in state.params["Pose"].named_parameters()}


@pytest.fixture(scope="module")
def runs(drive, tmp_path_factory):
    """An unbroken run of 3 iterations, a run of 2 and its resume to 3, and a
    run in timestamp mode (1 iteration)."""
    tmp = tmp_path_factory.mktemp("pose")
    out = {"whole": _train(drive, tmp / "whole", "--training.num_iters=3", *PINNED),
           "cut": _train(drive, tmp / "cut", "--training.num_iters=2", *PINNED)}
    out["cut_deltas"] = _deltas(out["cut"]["state"])
    out["resumed"] = _train(drive, tmp / "resumed", f"--resume_dir={tmp / 'cut'}",
                            "--training.num_iters=3", *PINNED)
    out["ts"] = _train(drive, tmp / "ts", "--training.num_iters=1", *TS_ARGV)
    return out


def test_the_overrides_bind_the_pose_asset_and_train_its_deltas(runs):
    tr = runs["whole"]
    trainer, state = tr["trainer"], tr["state"]
    assert tr["skips_total"] == 0 and math.isfinite(tr["psnr"])
    assert trainer.pose_model_id == "Pose" and trainer.pose_enable_after == 1
    assert not trainer.use_ts_interp
    assert isinstance(tr["bank"].assets["Pose"], LearnableParams)
    assert {k: tuple(v.shape) for k, v in state.params["Pose"].named_parameters()} == {
        "ego_car.dquat": (3, 3), "ego_car.dtrans": (3, 3), "camera_FRONT.dquat": (3, 3),
        "camera_FRONT.dtrans": (3, 3), "camera_FRONT.dintr": (3, 4)}
    assert {mid: int(opt.count) for mid, opt in state.opt.items()}["Pose"] == 3
    assert state.opt["Pose"].schedule(0) == pytest.approx(1e-3)
    for k, v in _deltas(state).items():
        assert torch.isfinite(v).all() and v.abs().max() > 0, k
        # one Adam step of 1e-3 past the gate at most, a few after it
        assert v.abs().max() <= 2 * 1e-3 + 1e-7, k
    for rec in tr["log"]:
        assert all(math.isfinite(rec[k]) for k in ("loss_rgb", "loss_mask", "loss_flow"))


def test_the_deltas_stay_zero_before_the_gate(runs):
    """``enable_after`` 1: the run of 2 moved them once (iteration 1); its
    first iteration left them exactly zero, so each moved by at most lr."""
    d = runs["cut_deltas"]
    assert all(v.abs().max() > 0 and v.abs().max() <= 1e-3 + 1e-9 for v in d.values())


def test_the_checkpoint_keeps_the_deltas_and_a_resume_takes_the_unbroken_steps(runs):
    exp = runs["cut"]["exp_dir"]
    cfg = load_config(os.path.join(exp, "config.json"))
    *_, fresh, _ = build_everything(cfg, "cpu", pretrain=False)
    assert all(not v.any() for v in _deltas(fresh).values())
    fresh, _ = CheckpointIO(os.path.join(exp, "ckpts")).load(fresh, "final")
    got = _deltas(fresh)
    assert set(got) == set(runs["cut_deltas"])
    assert all(torch.equal(got[k], v) for k, v in runs["cut_deltas"].items())
    assert torch.equal(fresh.opt["Pose"].count, runs["cut"]["state"].opt["Pose"].count)
    a, b = runs["whole"]["state"], runs["resumed"]["state"]
    assert a.it == b.it == 3
    for (k, x), (_, y) in zip(a.params.state_dict().items(), b.params.state_dict().items()):
        assert torch.equal(x, y), k


def test_timestamp_mode_trains_the_camera_s_timestamp_delta(runs):
    tr = runs["ts"]
    assert tr["trainer"].use_ts_interp and tr["skips_total"] == 0
    d = _deltas(tr["state"])
    assert d["camera_FRONT.dts"].shape == (3,)
    assert all(v.abs().max() > 0 for v in d.values())


def test_eval_and_replay_of_a_pose_run_apply_no_delta(runs, monkeypatch):
    """As JAX's tools: the frames render from the scenario's poses (every
    slice of the scene takes no deltas)."""
    from neuralsim_torch.scene import Scene
    seen = []
    orig = Scene.slice_at
    monkeypatch.setattr(Scene, "slice_at", lambda self, fi, pose_deltas=None: (
        seen.append(pose_deltas), orig(self, fi, pose_deltas))[1])
    exp = runs["whole"]["exp_dir"]
    at = ["--resume_dir", exp, "--device=cpu"]
    ev = single_eval.main(at + ["--eval.frames=0", "--eval.rayschunk=128"])
    assert all(math.isfinite(v) for v in ev["mean"].values() if v is not None)
    out = render.main(at + ["--render.mode=replay", "--render.frames=0", "--render.video=false"])
    assert "rgb_0000.png" in os.listdir(out["out_dir"])
    assert seen and all(d is None for d in seen)


def test_multi_object_training_refuses_pose_refinement(drive, tmp_path):
    argv = ["--config", MULTI_YAML, f"--exp_dir={tmp_path}",
            f"--dataset_cfg.params.root={drive}", "--device=cpu"] + POSE_ARGV
    with pytest.raises(NotImplementedError, match="pose refinement"):
        train_multi.main(argv)
    cfg = load_config(MULTI_YAML, [f"--dataset_cfg.params.root={drive}"] + POSE_ARGV)
    with pytest.raises(NotImplementedError, match="pose refinement"):
        build_multi_trainer(cfg, "cpu")


def test_the_multi_object_trainer_refuses_timestamp_mode():
    with pytest.raises(NotImplementedError, match="use_ts_interp"):
        MultiObjectTrainer(None, None, {}, use_ts_interp=True)
