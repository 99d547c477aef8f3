"""The port's config reader (``neuralsim_torch.config``) against the JAX
package's (``neuralsim_tpu.config``) on the CPU: every YAML of configs/,
read with and without dot overrides (``${eval:...}`` resolved after them),
the command-line values read without PyYAML, the command line itself
(``BaseConfig``, and ``tools.train.main`` for 2 iterations of StreetSurf at
narrow overrides), and ``WAYMO_STREETSURF`` against configs/waymo_streetsurf.yaml.
Everything is compared exactly: a config is data."""
import json
import pathlib

import numpy as np
import pytest
import torch
import yaml

from neuralsim_tpu.config import BaseConfig as JaxBaseConfig
from neuralsim_tpu.config import load_config as jax_load_config
from neuralsim_tpu.config import parse_cli_overrides as jax_parse_cli_overrides
from neuralsim_torch.config import (BaseConfig, ConfigDict, load_config, parse_cli_overrides,
                                    parse_value, resolve_interpolations, save_config)
from neuralsim_torch.configs import (MIRRORED_KEYS, WAYMO_DEMO_MULTI, WAYMO_STREETSURF,
                                     at_num_iters, resolve_refs)
from neuralsim_torch.tools.train import main

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
YAMLS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").glob("*.yaml"))
OVERRIDES = ["--training.num_iters=300", "seed=7", "--training.n_rays=2048",
             "--renderer.new_key=[1, 2.5, abc]", "--training.losses.rgb.w=0.5",
             "exp_dir=logs/run0"]


def test_every_config_of_the_repo_is_read():
    assert len(YAMLS) == 5 and "configs/waymo_streetsurf.yaml" in YAMLS


@pytest.mark.parametrize("path", YAMLS)
@pytest.mark.parametrize("overrides", [None, OVERRIDES], ids=["plain", "overrides"])
@pytest.mark.parametrize("resolve", [True, False], ids=["resolved", "raw"])
def test_reader_matches_jax(monkeypatch, path, overrides, resolve):
    monkeypatch.chdir(ROOT)
    want = jax_load_config(path, overrides, resolve=resolve)
    got = load_config(path, overrides, resolve=resolve)
    assert isinstance(got, ConfigDict) and got == want
    assert json.loads(json.dumps(got)) == got


def test_eval_resolves_after_the_overrides(monkeypatch):
    """``${eval:"${training.num_iters} // 5"}`` sees the command line's
    num_iters, not the file's."""
    monkeypatch.chdir(ROOT)
    cfg = load_config("configs/waymo_streetsurf.yaml", ["--training.num_iters=300"])
    mp = cfg["assetbank_cfg"]["Street"]["model_params"]
    assert (mp["inv_s_anneal_start_it"], mp["inv_s_anneal_stop_it"]) == (60, 300)
    assert cfg.assetbank_cfg.Street.asset_params.training_cfg.total_steps == 300
    raw = load_config("configs/waymo_streetsurf.yaml", resolve=False)
    assert raw["assetbank_cfg"]["Street"]["model_params"]["inv_s_anneal_start_it"] == \
        '${eval:"${training.num_iters} // 5"}'


VALUES = ["1", "-3", "+5", "0x1f", "017", "0b101", "1_000", "1.5", "1e-3", "1.0e-15", "3.",
          ".5", "1e3", "-.inf", ".nan", "true", "False", "on", "no", "yes", "null", "~", "",
          "foo", "logs/run0", "abc def", "[1, 2]", "[]", "[a, 1.5, [2, 3]]", "[1, 2,]",
          "{a: 1, b: [2, 3]}", "'quoted'", '"dq"', "1:30", "[0.1,0.2]", "[16, 24]"]


@pytest.mark.parametrize("v", VALUES)
def test_command_line_values_read_as_pyyaml_reads_them(v):
    got, want = parse_value(v), yaml.safe_load(v)
    assert type(got) is type(want)
    assert got == want or (got != got and want != want)


def test_overrides_nest_as_jax_nests_them():
    pairs = ["--a.b.c=1", "x=foo", "--a.b.d=[1, 2]", "novalue", "--e={f: 0.5}",
             '--g=${eval:"1 + 1"}']
    assert parse_cli_overrides(pairs) == jax_parse_cli_overrides(pairs)
    assert resolve_interpolations(parse_cli_overrides(pairs))["g"] == 2


def test_base_config_parses_as_jax_and_resumes_from_config_json(monkeypatch, tmp_path):
    monkeypatch.chdir(ROOT)
    argv = ["--config", "configs/synthetic_object.yaml", "--training.num_iters=10",
            "--resume_dir", "logs/x"]
    assert BaseConfig().parse(argv) == JaxBaseConfig().parse(argv)
    cfg = load_config("configs/waymo_demo_multi.yaml")
    save_config(cfg, str(tmp_path / "config.json"))
    back = BaseConfig().parse(["--resume_dir", str(tmp_path), "--training.n_rays=64"])
    assert back["training"]["n_rays"] == 64 and back["resume_dir"] == str(tmp_path)
    assert {k: v for k, v in back.items() if k not in ("resume_dir", "device_ids")} == \
        {**cfg, "training": {**cfg["training"], "n_rays": 64}}
    # allow_abbrev=False: --res=48 is a dot override, not --resume_dir
    assert BaseConfig().parse(["--res=48"])["res"] == 48


def test_streetsurf_config_mirrors_the_yaml(monkeypatch):
    monkeypatch.chdir(ROOT)
    want = jax_load_config("configs/waymo_streetsurf.yaml")
    got = resolve_refs(WAYMO_STREETSURF)
    for k in MIRRORED_KEYS + ("exp_dir",):
        if k != "dataset_cfg":
            assert got[k] == want[k], k
    assert set(got) == set(want)
    assert got["dataset_cfg"]["target"].endswith("waymo_demo.demo_sequence")
    assert got["dataset_cfg"]["params"] == WAYMO_DEMO_MULTI["dataset_cfg"]["params"]


@pytest.mark.parametrize("n", [3, 7, 300, 6000, 15000, 12345])
def test_streetsurf_schedule_at_another_length_matches_the_yaml(monkeypatch, n):
    monkeypatch.chdir(ROOT)
    want = jax_load_config("configs/waymo_streetsurf.yaml", [f"training.num_iters={n}"])
    got = resolve_refs(at_num_iters(WAYMO_STREETSURF, n))
    for k in ("assetbank_cfg", "renderer", "training"):
        assert got[k] == want[k], k
    assert at_num_iters(WAYMO_STREETSURF, 15000) == WAYMO_STREETSURF
    # the literal milestones and sparsity start of the YAML stay
    lid = got["training"]["losses"]
    assert lid["lidar"]["line_of_sight"]["epsilon"]["milestones"] == [3000, 8000]
    assert lid["sparsity"]["enable_after"] == 500


NARROW_ARGV = [
    "--dataset_cfg.target=neuralsim_torch.dataio.waymo_demo.demo_sequence",
    "--dataset_cfg.params={n_frames: 2, H: 16, W: 24, n_vehicles: 1, lidar_hw: [4, 16]}",
    "--training.num_iters=2", "--training.n_rays=32", "--training.n_rays_lidar=32",
    "--training.uniform_sample_n=16", "--training.i_log=1",
    "--assetbank_cfg.Street.model_params.encoding_cfg={type: tpu_mixed, n_levels: 4, "
    "base_res: 8, max_res: 64, n_feats: 2, n_hash_levels: 1, log2_hashmap_size: 10, "
    "cp_max_res: 64}",
    "--assetbank_cfg.Street.model_params.accel_cfg.resolution=16",
    "--assetbank_cfg.Street.model_params.pretrain.n_iters=2",
    "--assetbank_cfg.Street.model_params.pretrain.n_pts=64",
    "--assetbank_cfg.Street.model_params.query_cfg={num_coarse: 8, num_fine: [4, 4]}",
    "--assetbank_cfg.Distant.model_params.encoding_cfg={n_levels: 3, base_res: 4, "
    "max_res: 16, log2_hashmap_size: 10}",
    "--renderer.distant_query_cfg.num_samples=8"]


def test_main_trains_the_streetsurf_yaml_at_narrow_overrides(monkeypatch, tmp_path):
    """The command line on the CPU: the YAML, the demo drive for its Waymo
    sequence (the Waymo reader's params are left to the demo drive), narrow
    widths, 2 iterations of a LiDAR and a pixel step each."""
    monkeypatch.chdir(ROOT)
    out = main(["--config", "configs/waymo_streetsurf.yaml", f"--exp_dir={tmp_path}",
                "--device=cpu"] + NARROW_ARGV)
    assert out["state"].it == 2 and out["skips_total"] == 0 and np.isfinite(out["psnr"])
    assert [r["it"] for r in out["log"]] == [0, 1]
    assert all(np.isfinite(r["lidar/loss_lidar"]) for r in out["log"])
    with open(tmp_path / "config.json") as f:
        cfg = json.load(f)
    mp = cfg["assetbank_cfg"]["Street"]["model_params"]
    assert (mp["inv_s_anneal_start_it"], mp["inv_s_anneal_stop_it"]) == (0, 2)
    assert cfg["dataset_cfg"]["params"]["root"] == "/data/waymo/processed"
    assert out["bank"].assets["Distant#demo_drive"].field.encoding.input_dim == 4
