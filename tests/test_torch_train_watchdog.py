"""The finite guard's watchdog in both of the port's training loops
(``tools/train.py`` ``train`` and ``tools/train_multi.py`` ``train_loop``;
port of neuralsim_tpu/tools/train.py:304-330 and train_multi.py:194-319), on
the CPU at narrow widths.

A poisoned step (a NaN in the batch's colours) is skipped by the guard on the
device. At each log the loop reports the steps skipped since the last log and
goes on; when every step of a window of ``i_log`` steps was skipped it raises
``FloatingPointError``, worded as the JAX package words it.
"""
import copy

import numpy as np
import pytest
import torch

import neuralsim_torch.tools.train as train_mod
from neuralsim_torch.configs import SYNTHETIC_MULTI, SYNTHETIC_OBJECT
from neuralsim_torch.dataio.synthetic import SyntheticObjectDataset
from neuralsim_torch.tools.build import build_multi_trainer
from neuralsim_torch.tools.train import FiniteWatch, train
from neuralsim_torch.tools.train_multi import train_loop

torch.set_num_threads(1)

I_LOG = 2

SMALL_OBJECT = copy.deepcopy(SYNTHETIC_OBJECT)
SMALL_OBJECT["dataset_cfg"]["params"].update(n_frames=2, H=16, W=16)
SMALL_OBJECT["assetbank_cfg"]["Main"]["model_params"].update(
    encoding_cfg={"type": "tpu_mixed", "n_levels": 4, "base_res": 4, "max_res": 32,
                  "n_feats": 2, "n_hash_levels": 0, "cp_max_res": 32},
    geo_feat_dim=3,
    query_cfg={"num_coarse": 8, "num_fine": [4], "upsample_inv_s": 64.0,
               "upsample_inv_s_factors": [1.0]})
SMALL_OBJECT["assetbank_cfg"]["Sky"]["model_params"] = {"hidden": 8}
SMALL_OBJECT["training"].update(n_rays=32, uniform_sample_n=16, i_log=I_LOG)

SMALL_MULTI = copy.deepcopy(SYNTHETIC_MULTI)
SMALL_MULTI["dataset_cfg"]["params"].update(n_frames=2, H=16, W=16)
_B = SMALL_MULTI["assetbank_cfg"]
_B["Vehicle"]["model_params"].update(
    z_dim=2, geo_feat_dim=3, radiance_hidden=8,
    encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2, "cp_max_res": 32},
    query_cfg={"num_coarse": 6, "num_fine": [2], "upsample_inv_s_factors": [1.0]})
_B["Street"]["model_params"].update(
    geo_feat_dim=3, radiance_hidden=8,
    encoding_cfg={"type": "tpu_mixed", "n_levels": 4, "base_res": 4, "max_res": 32,
                  "n_feats": 2, "n_hash_levels": 0, "cp_max_res": 32},
    query_cfg={"num_coarse": 6, "num_fine": [2, 2], "upsample_inv_s_factors": [1.0, 4.0]},
    pretrain={"type": "road_surface", "z_road": -0.6, "up_axis": 2, "n_iters": 2, "n_pts": 32})
_B["Sky"]["model_params"] = {"hidden": 8}
SMALL_MULTI["training"].update(n_rays=32, uniform_sample_n=16, i_log=I_LOG)


def _poisoned_object_dataset(steps):
    """The synthetic object dataset whose batches at ``steps`` carry a NaN."""
    class Poisoned(SyntheticObjectDataset):
        calls = 0

        def sample_pixels(self, rng, n):
            out = super().sample_pixels(rng, n)
            if Poisoned.calls in steps:
                out["image_rgb"] = out["image_rgb"].copy()
                out["image_rgb"][0, 0] = np.nan
            Poisoned.calls += 1
            return out
    return Poisoned


class _PoisonedSampler:
    """A pixel sampler whose batches at ``steps`` carry a NaN."""

    def __init__(self, sampler, steps):
        self.inner, self.steps, self.calls = sampler, steps, 0
        self.loader, self.n_rays = sampler.loader, sampler.n_rays

    def sample(self, n_rays=None):
        out = self.inner.sample(n_rays)
        if self.calls in self.steps:
            out["image_rgb"] = out["image_rgb"].copy()
            out["image_rgb"][0, 0] = np.nan
        self.calls += 1
        return out


def _run_object(monkeypatch, steps, n_iters=5):
    monkeypatch.setattr(train_mod, "SyntheticObjectDataset", _poisoned_object_dataset(steps))
    return train(SMALL_OBJECT, n_iters, device="cpu")


def _run_multi(steps, n_iters=5):
    scene, _, trainer, state, samplers = build_multi_trainer(SMALL_MULTI, device="cpu")
    assert samplers["lidar"] is None           # pixel steps only: one step an iteration
    samplers = {**samplers, "pixel": _PoisonedSampler(samplers["pixel"], steps)}
    log = []
    state = train_loop(scene, trainer, state, samplers, n_iters, torch.Generator().manual_seed(0),
                       I_LOG, log)
    return state, log


def test_train_raises_when_every_step_of_a_window_is_skipped(monkeypatch, capsys):
    with pytest.raises(FloatingPointError, match="every step in the last 2-iteration window "
                                                 "was skipped by the finite guard at it=2"):
        _run_object(monkeypatch, {1, 2})
    assert "[finite-guard] 2 poisoned step(s) skipped since last log (total 2)" in \
        capsys.readouterr().out


def test_train_logs_one_skipped_step_and_goes_on(monkeypatch, capsys):
    out = _run_object(monkeypatch, {1})
    assert out["state"].it == 5 and int(out["state"].skips) == 1
    assert [r["it"] for r in out["log"]] == [0, 2, 4]
    text = capsys.readouterr().out
    assert "[finite-guard] 1 poisoned step(s) skipped since last log (total 1)" in text
    assert text.count("[finite-guard]") == 1


def test_train_loop_raises_when_every_step_of_a_window_is_skipped(capsys):
    with pytest.raises(FloatingPointError, match="every step in the last 2-iteration window "
                                                 "was skipped by the finite guard at it=4"):
        _run_multi({3, 4})
    assert "[finite-guard] 2 poisoned step(s) skipped since last log (total 2)" in \
        capsys.readouterr().out


def test_train_loop_logs_one_skipped_step_and_goes_on(capsys):
    state, log = _run_multi({2})
    assert state.it == 5 and int(state.skips) == 1 and [r["it"] for r in log] == [0, 2, 4]
    assert log[1]["step_skipped"] == 1 and not np.isfinite(log[1]["loss_total"])
    text = capsys.readouterr().out
    assert "[finite-guard] non-finite metrics at it=2" in text
    assert "[finite-guard] 1 poisoned step(s) skipped since last log (total 1)" in text


def test_the_first_log_never_raises():
    """As the JAX package's: at it=0 the window is one step (``it > 0``), and
    the watch starts from the skips the state already has."""
    watch = FiniteWatch(1, skips=3)
    watch.check({"skips_total": 4.0, "loss_total": float("nan")}, 0)
    watch.check({"skips_total": 4.0}, 1)
    with pytest.raises(FloatingPointError):
        watch.check({"skips_total": 5.0}, 2)
