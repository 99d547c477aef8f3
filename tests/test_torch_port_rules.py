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
                                    WAYMO_DEMO_CROWD, WAYMO_DEMO_MULTI, WAYMO_DEMO_PERMUTO)
from neuralsim_torch.fields.blocks import MLP
from neuralsim_torch.tools.build import (build_compose_renderer, build_multi_trainer,
                                         build_renderer, build_trainer)
from neuralsim_torch.tools.train import train
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
              "dataio.synthetic_multi", "fields.encodings.permuto"):
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
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for new in ("ops/pair_compact.py", "dataio/synthetic_multi.py", "accel/occ_grid.py",
                "fields/encodings/permuto.py", "fields/conditional.py"):
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
    for entry in ("lotd_cp_stacked_bwd", "lotd_grid_bwd", "volume_composite_bwd",
                  "occ_ray_proposal", "occ_ema_update", "cross_source_vw",
                  "cross_source_vw_bwd", "pair_compact", "lotd_cp_level_fwd",
                  "lotd_cp_level_bwd", "neus_composite_fwd", "neus_composite_bwd",
                  "permuto_fwd", "permuto_bwd"):
        assert entry in found


def test_every_kernel_is_registered_once_with_its_source():
    import neuralsim_torch.fields.neus  # noqa: F401  (registers K5a, K5b and the rest)
    import neuralsim_torch.renderers.buffers  # noqa: F401
    import neuralsim_torch.renderers.neus_composite  # noqa: F401
    import neuralsim_torch.accel.occ_grid  # noqa: F401
    import neuralsim_torch.ops.pair_compact  # noqa: F401
    import neuralsim_torch.fields.encodings.permuto  # noqa: F401
    names = set(kernels.KERNELS)
    assert names == {"lotd_cp_stacked", "lotd_cp_stacked.bwd", "lotd_grid", "lotd_grid.bwd",
                     "neus_upsample.weights_pdf", "neus_upsample.merge", "volume_composite",
                     "volume_composite.bwd", "occ_ray_proposal", "occ_ema_update",
                     "cross_source_vw", "cross_source_vw.bwd", "occ_ray_proposal_batched",
                     "pair_compact", "lotd_cp_level", "lotd_cp_level.bwd", "neus_composite",
                     "neus_composite.bwd", "permuto", "permuto.bwd"}
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
