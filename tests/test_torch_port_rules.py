"""Rules of the PyTorch port: it imports neither JAX nor the JAX package, its
entry points run on the card unless the CPU is asked for, and the parameter
bridge refuses trees that do not match."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from neuralsim_torch import kernels
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.configs import (BENCH_OBJECT, SYNTHETIC_MULTI, SYNTHETIC_OBJECT,
                                    WAYMO_DEMO_CROWD, WAYMO_DEMO_MULTI, WAYMO_DEMO_PERMUTO,
                                    WAYMO_STREETSURF)
from neuralsim_torch.fields.blocks import MLP
from neuralsim_torch.tools.build import (build_compose_renderer, build_everything,
                                         build_multi_trainer, build_renderer, build_trainer)
from neuralsim_torch.tools.train import main as train_single_cli
from neuralsim_torch.tools.train import main_function as train_single_main
from neuralsim_torch.tools.train import train
from neuralsim_torch.tools.eval_lidar import main_function as eval_lidar_main
from neuralsim_torch.tools.eval_multi import main_function as eval_multi_main
from neuralsim_torch.tools.train_multi import main_function as train_main
from neuralsim_torch.tools.train_multi import train_multi

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "neuralsim_torch"


def _modules():
    out = []
    for p in PKG.rglob("*.py"):
        parts = p.relative_to(ROOT).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return sorted(out)


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest)."""
    mods = _modules()
    for m in ("fields.encodings.lotd", "training.trainer", "training.optimizers",
              "training.annealers", "losses.core", "losses.recon", "tools.train",
              "accel", "accel.occ_grid", "fields.nerf", "fields.conditional",
              "maths.transforms", "scene", "scene.nodes", "scene.scene", "scene.asset_bank",
              "scene.observers.cameras", "scene.observers.cameras_math", "dataio.waymo_demo",
              "models.asset_base", "renderers.buffer_compose", "training.multi_trainer",
              "training.error_map", "dataio.dataloader", "scene.observers.lidars",
              "tools.train_multi", "models.assets", "ops.pair_compact",
              "dataio.synthetic_multi", "fields.encodings.permuto", "ops.latent_take",
              "utils", "utils.checkpoint", "utils.logger", "utils.misc", "maths.metrics",
              "tools.eval_multi", "tools.eval_lidar", "config", "config.config",
              "fields.embeddings", "scene.scene_bank", "tools.build", "fields.emernerf",
              "anim", "anim.anim", "graphics", "graphics.marching", "models.misc_assets",
              "tools.render", "tools.manipulate", "tools.extract_mesh", "tools.extract_occgrid",
              "tools.extract_visible_grid", "tools.visualize_slice", "tools.run"):
        assert f"neuralsim_torch.{m}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'neuralsim_tpu')]\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules if m.startswith('neuralsim_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(mods)


def test_sources_do_not_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|neuralsim_tpu)\b", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
        sorted((ROOT / "scripts").glob("torch_*.py"))
    assert ROOT / "scripts" / "torch_run_waymo_demo.py" in files
    assert ROOT / "scripts" / "torch_finish_waymo_demo.py" in files
    for new in ("ops/pair_compact.py", "dataio/synthetic_multi.py", "accel/occ_grid.py",
                "fields/encodings/permuto.py", "fields/conditional.py", "ops/latent_take.py",
                "utils/checkpoint.py", "tools/eval_multi.py", "tools/eval_lidar.py",
                "config/config.py", "config/__init__.py", "fields/embeddings.py",
                "scene/scene_bank.py", "fields/emernerf.py", "anim/anim.py",
                "graphics/marching.py", "models/misc_assets.py", "scene/observers/lidars.py",
                "tools/manipulate.py", "tools/extract_mesh.py", "tools/extract_occgrid.py",
                "tools/extract_visible_grid.py", "tools/visualize_slice.py", "tools/run.py"):
        assert PKG / new in files
    for f in files:
        assert not pat.search(f.read_text()), f


@pytest.mark.parametrize("entry", [build_renderer, build_trainer, train],
                         ids=lambda f: f.__name__)
def test_entry_point_defaults_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(SYNTHETIC_OBJECT)


@pytest.mark.parametrize("entry", [build_renderer, build_trainer, train],
                         ids=lambda f: f.__name__)
def test_entry_point_defaults_to_the_card_for_the_bench_model(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(BENCH_OBJECT)


@pytest.mark.parametrize("cfg", [WAYMO_DEMO_MULTI, WAYMO_DEMO_CROWD, SYNTHETIC_MULTI,
                                 WAYMO_DEMO_PERMUTO],
                         ids=["waymo_demo_multi", "waymo_demo_crowd", "synthetic_multi",
                              "waymo_demo_permuto"])
def test_compose_entry_point_defaults_to_the_card(monkeypatch, cfg):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_compose_renderer(cfg)


@pytest.mark.parametrize("cfg", [WAYMO_DEMO_MULTI, WAYMO_DEMO_CROWD, SYNTHETIC_MULTI,
                                 WAYMO_DEMO_PERMUTO],
                         ids=["waymo_demo_multi", "waymo_demo_crowd", "synthetic_multi",
                              "waymo_demo_permuto"])
@pytest.mark.parametrize("entry", [build_multi_trainer, train_multi], ids=lambda f: f.__name__)
def test_multi_object_training_entry_points_default_to_the_card(monkeypatch, entry, cfg):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(cfg)


@pytest.mark.parametrize("entry", [train_main, eval_multi_main, eval_lidar_main],
                         ids=["train_multi", "eval_multi", "eval_lidar"])
def test_driver_main_functions_default_to_the_card(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {**WAYMO_DEMO_MULTI, "exp_dir": str(tmp_path / "exp"),
           "renderer": {**WAYMO_DEMO_MULTI["renderer"], "type": "multi"}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(cfg)
    assert not (tmp_path / "exp").exists()


SIM_TOOLS = {"render_lidar": ("render", "lidar"), "render_nvs": ("render", "nvs"),
             "manipulate": ("manipulate", None), "extract_mesh": ("extract_mesh", None),
             "extract_occgrid": ("extract_occgrid", None),
             "extract_visible_grid": ("extract_visible_grid", None),
             "visualize_slice": ("visualize_slice", None)}


@pytest.mark.parametrize("tool", list(SIM_TOOLS) + ["lidar_generator"])
def test_simulation_tools_default_to_the_card(monkeypatch, tmp_path, tool):
    """The main_function of each sensor-simulation and editing tool on
    WAYMO_DEMO_MULTI (the compose branch) and WAYMO_STREETSURF (the
    single-scene one), refused without the card before any file is written;
    a synthetic LiDAR's beams are handed to the card by default."""
    import importlib
    from neuralsim_torch.scene.observers.lidars import make_lidar_generator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if tool == "lidar_generator":
        # this CPU build of torch has no CUDA: moving a tensor to the card fails
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            make_lidar_generator("pandar64").get_all_rays()
        return
    module, mode = SIM_TOOLS[tool]
    main_function = importlib.import_module(f"neuralsim_torch.tools.{module}").main_function
    multi = {**WAYMO_DEMO_MULTI, "renderer": {**WAYMO_DEMO_MULTI["renderer"], "type": "multi"}}
    for cfg in (multi, WAYMO_STREETSURF):
        cfg = {**cfg, "exp_dir": str(tmp_path / "exp"), "render": {"mode": mode}}
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main_function(cfg)
    assert not (tmp_path / "exp").exists()


def test_single_scene_tool_defaults_to_the_card(monkeypatch, tmp_path):
    """build_everything, main_function and the command line of
    tools/train.py on WAYMO_STREETSURF: refused before any file is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {**WAYMO_STREETSURF, "exp_dir": str(tmp_path / "exp")}
    for entry in (build_everything, train_single_main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_single_cli(["--config", str(ROOT / "configs" / "waymo_streetsurf.yaml"),
                          f"--exp_dir={tmp_path / 'exp'}", "--dataset_cfg.target="
                          "neuralsim_torch.dataio.waymo_demo.demo_sequence"])
    assert not (tmp_path / "exp").exists()


def test_the_config_reader_imports_pyyaml_only_for_a_yaml_file(tmp_path):
    """In a fresh interpreter: reading a JSON config, command-line values
    and the whole single-scene tool load no PyYAML."""
    (tmp_path / "c.json").write_text('{"a": {"b": "${eval:\'1 + 2\'}"}}')
    code = ("import sys\n"
            "from neuralsim_torch.config import BaseConfig\n"
            "import neuralsim_torch.tools.train\n"
            f"c = BaseConfig().parse(['--config', {str(tmp_path / 'c.json')!r}, '--x=[1, 2]'])\n"
            "assert c['a']['b'] == 3 and c['x'] == [1, 2], c\n"
            "assert 'yaml' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_ctypes_signatures_match_the_cuda_sources():
    """The argtypes declared in kernels.py against each extern "C" entry in
    csrc/ (nvcc is not available here to catch a mismatch)."""
    codes = {"const void*": "p", "void*": "p", "int": "i", "float": "f"}
    found = {}
    for src in (PKG / "csrc").glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            types = [" ".join(p.split()[:-1]) for p in params.split(",")]
            found[name] = "".join(codes[t] for t in types)
    assert found == kernels.SIGNATURES
    for entry in ("lotd_cp_stacked_bwd", "lotd_grid_bwd", "lotd_grid_bwd_x", "volume_composite_bwd",
                  "occ_ray_proposal", "occ_ema_update", "occ_voxel_points", "cross_source_vw",
                  "cross_source_vw_bwd", "pair_compact", "lotd_cp_level_fwd",
                  "lotd_cp_level_bwd", "neus_composite_fwd", "neus_composite_bwd",
                  "permuto_fwd", "permuto_bwd", "latent_take_fwd", "latent_take_bwd",
                  "lotd_cp_lines_fwd", "lotd_cp_lines_bwd"):
        assert entry in found


def test_every_kernel_is_registered_once_with_its_source():
    import neuralsim_torch.fields.neus  # noqa: F401  (registers K5a, K5b and the rest)
    import neuralsim_torch.renderers.buffers  # noqa: F401
    import neuralsim_torch.renderers.neus_composite  # noqa: F401
    import neuralsim_torch.accel.occ_grid  # noqa: F401
    import neuralsim_torch.ops.pair_compact  # noqa: F401
    import neuralsim_torch.fields.encodings.permuto  # noqa: F401
    import neuralsim_torch.ops.latent_take  # noqa: F401
    names = set(kernels.KERNELS)
    assert names == {"lotd_cp_stacked", "lotd_cp_stacked.bwd", "lotd_grid", "lotd_grid.bwd",
                     "neus_upsample.weights_pdf", "neus_upsample.merge", "volume_composite",
                     "volume_composite.bwd", "occ_ray_proposal", "occ_ema_update",
                     "occ_voxel_points",
                     "cross_source_vw", "cross_source_vw.bwd", "occ_ray_proposal_batched",
                     "pair_compact", "lotd_cp_level", "lotd_cp_level.bwd", "neus_composite",
                     "neus_composite.bwd", "permuto", "permuto.bwd", "latent_take",
                     "latent_take.bwd", "lotd_cp_lines", "lotd_cp_lines.bwd", "lotd_grid4",
                     "lotd_grid4.bwd", "lotd_grid.bwd_x"}
    for k in kernels.KERNELS.values():
        assert (ROOT / k.source).exists() and re.match(r"neuralsim_tpu/.+\.py:\d+$", k.replaces)
        assert (ROOT / k.replaces.split(":")[0]).exists()


def test_chip_smoke_refuses_to_run_without_cuda():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bridge_refuses_mismatched_trees():
    mlp = MLP(4, 2, hidden=8, depth=1)
    good = {"layers": [{"W": np.ones((4, 8)), "b": np.zeros(8)},
                       {"W": np.ones((8, 2)), "b": np.full(2, 3.0)}]}
    load_jax_params(mlp, good)
    assert torch.equal(mlp.layers[1].b, torch.full((2,), 3.0))
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(mlp, {"layers": good["layers"][:1]})
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(mlp, {**good, "ln_inv_s": np.zeros(())})
    bad = {"layers": [good["layers"][0], {"W": np.ones((2, 8)), "b": np.zeros(2)}]}
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(mlp, bad)
