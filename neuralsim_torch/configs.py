"""Config dicts for the port, so it runs where PyYAML is missing (the YAML
files themselves go through ``neuralsim_torch.config``).

``SYNTHETIC_OBJECT`` mirrors configs/synthetic_object.yaml (dataset, asset
bank, renderer and training keys): NeuS object reconstruction on the
procedural synthetic scene, an LoTD of 6 stacked-CP and 2 hash levels and a
sky MLP. ``${a.b}`` references stay as written, as in the YAML;
:func:`resolve_refs` replaces them.

``BENCH_OBJECT`` mirrors, value by value, the model that the JAX package's
``bench.py`` (lines 56-125) builds by hand, with that script's environment
knobs at their defaults: a NeuS field on 12 stacked-CP levels of 8 features
(16 .. 1,024), an EMA occupancy grid of 128^3, the NeRF++ distant MLP and a
sky, trained on 8,192 rays a step. It names fields, not asset classes (the
assets cannot express its grid and distant settings), so it has its own
layout: ``models`` {role: {field, params}}, ``accel_cfg`` {role: grid
settings}, ``occ_converge`` (the grid's warm-up against the scene's analytic
SDF), ``renderer`` and ``training``.

``WAYMO_DEMO_MULTI`` mirrors configs/waymo_demo_multi.yaml value by value: the
multi-object driving scene (3 vehicles on one shared conditional LoTD model,
the street's LoTD NeuS with its occupancy grid, the NeRF++ distant field, the
sky) under the compose renderer. Its ``${eval:...}`` schedule entries stand
resolved, at ``num_iters`` 6,000; :func:`at_num_iters` sets them for another
length of the schedule, as the YAML's expressions do. Its dataset is the in-memory demo scenario
(``dataio/waymo_demo.demo_scenario``, the generator's defaults) in place of
the files that ``dataio/waymo_demo.build_demo_sequence`` writes (the YAML
itself reads those through ``dataio/waymo.WaymoDataset``: its frames are
JPEGs); ``occ_converge`` is the street grid's warm-up against the drive's
static ground.

``WAYMO_DEMO_CROWD`` is a port-side variant of ``WAYMO_DEMO_MULTI`` with
exactly two changes: the demo drive has 8 vehicles, so the shared vehicle
model's group (K = 8 > 4) takes the pair-budget path under
``group_budget_frac: auto`` (kernel K11), and the vehicles get per-instance
occupancy grids (``accel_cfg``, the values ``OccGridEmaBatched`` takes by
default in the JAX package; kernel K10). No YAML of the repo sets a vehicle
``accel_cfg``, so the tests build the JAX package from this dict too.

``WAYMO_DEMO_PERMUTO`` is a port-side variant of ``WAYMO_DEMO_MULTI`` with
exactly one change: the vehicles' ``model_class`` is
``ADGenerativePermutoConcatNeuSObj``, the reference's model of categorical
classes (the permuto vehicles of the configuration that
configs/waymo_demo_multi.yaml mirrors). Every other ``model_params`` value
stays; the permuto asset reads no ``encoding_cfg`` and builds its default
lattice: 12 levels of 2 features from resolution 4 to 256, a 2^17-row table a
level, over concat(xyz01, sigmoid(z)) with z_dim 8, so d = 11 (kernel K9).
No YAML of the repo sets this class, so the tests build the JAX package from
this dict too.

``WAYMO_STREETSURF`` mirrors configs/waymo_streetsurf.yaml value by value
outside ``dataset_cfg``: StreetSurf's single street (the street's LoTD NeuS
of 9 stacked-CP and 3 hash levels of F 4 in the box of the camera tracks
widened by 60 m, its 128^3 grid and road pretrain; the 4-D LoTD distant
field; the sky; appearance inputs of 4 on all three) trained on camera rays
and LiDAR beams by the single-scene tool (``tools.train.main_function``).
Its one ``${eval:...}`` entry, the street's inv_s anneal start, stands
resolved at ``num_iters`` 15,000 (:func:`at_num_iters` sets it for another
length); ``${training.num_iters}`` references stay as written. Its dataset
is the in-memory demo drive (``dataio/waymo_demo.demo_sequence``) in place of
the YAML's preprocessed Waymo sequence (the YAML runs as written on the demo
drive written to disk, ``root`` pointed at it).

``SYNTHETIC_MULTI`` mirrors configs/synthetic_multi.yaml value by value: two
spheres on one shared conditional LoTD model over a ground plane (the street's
LoTD NeuS with 2 hash levels, no grid, no distant field) and a sky, on the
procedural ``SyntheticMultiObjectDataset``. Its renderer block sets no
``group_budget_frac``, so the training default of 1.0 puts the two spheres on
the pair-budget path.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict

from .config import load_config as _load_config
from .config import resolve_interpolations

SYNTHETIC_OBJECT: Dict[str, Any] = {
    "seed": 42,
    "dataset_cfg": {
        "target": "neuralsim_tpu.dataio.synthetic_scene.SyntheticSceneDataset",
        "params": {"n_frames": 24, "H": 96, "W": 96, "radius": 2.0},
    },
    "assetbank_cfg": {
        "Main": {
            "model_class": "neuralsim_tpu.models.assets.LoTDNeuSObj",
            "model_params": {
                "extent": 1.0,
                "encoding_cfg": {"type": "tpu_mixed", "n_levels": 8, "base_res": 16,
                                 "max_res": 256, "n_feats": 2, "n_hash_levels": 2,
                                 "log2_hashmap_size": 15, "cp_max_res": 128},
                "geo_feat_dim": 15,
                "inv_s_init": 30.0,
                "cos_anneal_stop_it": 500,
                "query_cfg": {"num_coarse": 64, "num_fine": [16, 16],
                              "upsample_inv_s": 64.0,
                              "upsample_inv_s_factors": [1.0, 4.0]},
            },
            "asset_params": {
                "training_cfg": {"lr": 0.01, "eps": 1.0e-15, "betas": [0.9, 0.99],
                                 "type": "exponential",
                                 "total_steps": "${training.num_iters}",
                                 "decay_target_factor": 0.1},
            },
        },
        "Sky": {
            "model_class": "neuralsim_tpu.models.assets.SimpleSkyAsset",
            "model_params": {"hidden": 32},
            "asset_params": {"training_cfg": {"lr": 0.003}},
        },
    },
    "renderer": {"cr_class": "Main", "sky_class": "Sky"},
    "training": {
        "num_iters": 1500,
        "n_rays": 2048,
        "uniform_sample_n": 512,
        "i_log": 100,
        "i_val": 500,
        "val_downscale": 2,
        "with_mask": True,
        "losses": {
            "rgb": {"fn_type": "huber", "fn_param": {"delta": 0.1}, "w": 10.0},
            "occupancy_mask": {"w": 0.3},
            "eikonal": {"w": 0.01, "on_render_ratio": 0.3},
            "sparsity": {"w": 0.002},
        },
    },
}

BENCH_OBJECT: Dict[str, Any] = {
    "seed": 0,
    "dataset_cfg": {"params": {"n_frames": 4, "H": 128, "W": 128}},
    "models": {
        "cr": {
            "field": "NeuSField",
            "aabb": [[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]],
            "params": {
                "encoding_cfg": {"type": "tpu_mixed", "n_levels": 12, "base_res": 16,
                                 "max_res": 1024, "n_feats": 8, "n_hash_levels": 0,
                                 "log2_hashmap_size": 17, "cp_max_res": 2048},
                "geo_feat_dim": 15, "decoder_hidden": 64, "radiance_hidden": 64,
                "ln_inv_s_init": math.log(30.0), "cos_anneal_stop_it": 500,
                "eval_chunk": 2_000_000,
            },
        },
        "distant": {
            "field": "NeRFDistantField",
            "params": {"inner_radius": 1.0, "geometry": "mlp", "geo_feat_dim": 8,
                       "radiance_hidden": 32},
        },
        "sky": {"field": "SimpleSky", "params": {"hidden": 32}},
    },
    "renderer": {
        "query_cfg": {"num_coarse": 16, "num_fine": [8, 8], "upsample_inv_s": 64.0,
                      "upsample_inv_s_factors": [1.0, 4.0]},
        "distant_query_cfg": {"num_samples": 32},
    },
    "accel_cfg": {"cr": {"resolution": 128, "n_warmup_steps": 0, "occ_inv_s": 64.0,
                         "march_steps": 48}},
    "occ_converge": {"n": 40, "it": 1000},
    "training": {
        "num_iters": 30,            # the steps that bench.py times
        "n_rays": 8192,
        "uniform_sample_n": 1024,
        "i_log": 100,
        "with_mask": True,
        "losses": {
            "rgb": {"fn_type": "huber", "w": 10.0},
            "occupancy_mask": {"w": 0.3},
            "eikonal": {"w": 0.01, "on_render_ratio": 0.3},
            "sparsity": {"w": 0.002},
        },
        # each model's Adam; no schedule type is named, so each follows the
        # optimizer's default one (exponential to a tenth over 10,000 steps)
        "optim": {"cr": {"lr": 1e-2}, "distant": {"lr": 5e-3}, "sky": {"lr": 3e-3}},
    },
}

WAYMO_DEMO_MULTI: Dict[str, Any] = {
    "exp_dir": "logs/waymo_demo_multi",
    "seed": 42,
    "dataset_cfg": {
        "target": "neuralsim_torch.dataio.waymo_demo.demo_scenario",
        "params": {"n_frames": 8, "H": 80, "W": 120, "n_vehicles": 3, "seed": 0},
    },
    "assetbank_cfg": {
        "Vehicle": {
            "model_class": "neuralsim_tpu.models.assets.ADGenerativeLoTDConcatNeuSObj",
            "model_params": {
                "z_dim": 8,
                "encoding_cfg": {"n_levels": 8, "base_res": 8, "max_res": 256, "n_feats": 4,
                                 "cp_max_res": 256},
                "geo_feat_dim": 15,
                "radiance_hidden": 32,
                "inv_s_init": 30.0,
                "query_cfg": {"num_coarse": 24, "num_fine": [8],
                              "upsample_inv_s_factors": [1.0]},
            },
            "asset_params": {"training_cfg": {"lr": 0.008}},
        },
        "Street": {
            "model_class": "neuralsim_tpu.models.assets.LoTDNeuSStreet",
            "model_params": {
                "aabb": [[-8.0, -35.0, -0.8], [75.0, 35.0, 7.0]],
                "encoding_cfg": {"type": "tpu_mixed", "n_levels": 10, "base_res": 16,
                                 "max_res": 1024, "n_feats": 4, "n_hash_levels": 0,
                                 "log2_hashmap_size": 17, "cp_max_res": 1024},
                "geo_feat_dim": 15,
                "radiance_hidden": 64,
                "inv_s_init": 10.0,
                "inv_s_final": 30.0,
                "inv_s_anneal_start_it": 1200,        # num_iters // 5
                "inv_s_anneal_stop_it": 6000,         # num_iters
                "pretrain": {"type": "road_surface", "z_road": 0.0, "up_axis": 2,
                             "n_iters": 800},
                "accel_cfg": {"resolution": 128, "occ_thre": 0.3, "ema_decay": 0.95,
                              "inv_s": 10.0, "n_steps_between_update": 16,
                              "samples_per_voxel": 4},
                "query_cfg": {"num_coarse": 32, "num_fine": [8, 8], "upsample_inv_s": 64.0,
                              "upsample_inv_s_factors": [1.0, 4.0]},
            },
            "asset_params": {"training_cfg": {"lr": 0.01}},
        },
        "Distant": {
            "model_class": "neuralsim_tpu.models.assets.NeRFDistant",
            "model_params": {"geometry": "mlp", "geo_feat_dim": 8,
                             "query_cfg": {"num_samples": 24}},
            "asset_params": {"training_cfg": {"lr": 0.005}},
        },
        "Sky": {
            "model_class": "neuralsim_tpu.models.assets.SimpleSkyAsset",
            "model_params": {"hidden": 32},
            "asset_params": {"training_cfg": {"lr": 0.003}},
        },
    },
    "renderer": {"cr_class": "Street", "distant_class": "Distant", "sky_class": "Sky",
                 "group_budget_frac": "auto", "max_hits_per_ray": 4},
    "training": {
        "num_iters": 6000,
        "n_rays": 4096,
        "n_rays_lidar": 2048,
        "with_mask": True,
        "with_lidar": True,
        "uniform_sample_n": 512,
        "i_log": 100,
        "error_map": {"hw": [16, 24], "frac_uniform": 0.5, "enable_after": 200},
        "losses": {
            "rgb": {"fn_type": "huber", "fn_param": {"delta": 0.1}, "w": 10.0},
            "occupancy_mask": {"w": 0.3},
            "eikonal": {"w": 0.01, "on_render_ratio": 0.3},
            "sparsity": {"w": 0.002, "enable_after": 600,
                         "anneal": {"type": "linear", "start_it": 600, "start_val": 0.0,
                                    "stop_it": 3000, "stop_val": 1.0}},
            "clearance": {"w": 0.1, "beta": 10.0, "thresh": 0.02},
            "latent": {"w": 0.001},
            "lidar": {"w": 1.0, "depth": {"fn_type": "l1", "w": 0.5},
                      "line_of_sight": {"fn_type": "neus_unisim", "w": 0.02,
                                        "epsilon": {"type": "milestones",
                                                    "milestones": [2000, 4000],
                                                    "vals": [1.5, 0.75, 0.5]}}},
        },
    },
    "occ_converge": {"n": 40, "it": 1000},
}

WAYMO_DEMO_CROWD: Dict[str, Any] = copy.deepcopy(WAYMO_DEMO_MULTI)
WAYMO_DEMO_CROWD["dataset_cfg"]["params"]["n_vehicles"] = 8
WAYMO_DEMO_CROWD["assetbank_cfg"]["Vehicle"]["model_params"]["accel_cfg"] = {
    "resolution": 32, "occ_thre": 0.3, "ema_decay": 0.95, "inv_s": 256.0}

WAYMO_DEMO_PERMUTO: Dict[str, Any] = copy.deepcopy(WAYMO_DEMO_MULTI)
WAYMO_DEMO_PERMUTO["assetbank_cfg"]["Vehicle"]["model_class"] = \
    "neuralsim_tpu.models.assets.ADGenerativePermutoConcatNeuSObj"

SYNTHETIC_MULTI: Dict[str, Any] = {
    "exp_dir": "logs/synthetic_multi",
    "seed": 42,
    "dataset_cfg": {
        "target": "neuralsim_tpu.dataio.synthetic_multi.SyntheticMultiObjectDataset",
        "params": {"n_frames": 8, "H": 64, "W": 64},
    },
    "assetbank_cfg": {
        "Vehicle": {
            "model_class": "neuralsim_tpu.models.assets.ADGenerativeLoTDConcatNeuSObj",
            "model_params": {
                "z_dim": 8,
                "encoding_cfg": {"n_levels": 8, "base_res": 8, "max_res": 128, "n_feats": 4,
                                 "cp_max_res": 128},
                "geo_feat_dim": 15,
                "radiance_hidden": 32,
                "inv_s_init": 30.0,
                "query_cfg": {"num_coarse": 24, "num_fine": [8],
                              "upsample_inv_s_factors": [1.0]},
            },
            "asset_params": {"training_cfg": {"lr": 0.008}},
        },
        "Street": {
            "model_class": "neuralsim_tpu.models.assets.LoTDNeuSStreet",
            "model_params": {
                "aabb": [[-4.0, -4.0, -1.2], [4.0, 4.0, 1.6]],
                "encoding_cfg": {"type": "tpu_mixed", "n_levels": 8, "base_res": 8,
                                 "max_res": 256, "n_feats": 2, "n_hash_levels": 2,
                                 "log2_hashmap_size": 15},
                "geo_feat_dim": 15,
                "radiance_hidden": 32,
                "inv_s_init": 20.0,
                "accel_cfg": None,
                "pretrain": {"type": "road_surface", "z_road": -0.6, "up_axis": 2},
                "query_cfg": {"num_coarse": 48, "num_fine": [8, 8],
                              "upsample_inv_s_factors": [1.0, 4.0]},
            },
            "asset_params": {"training_cfg": {"lr": 0.008}},
        },
        "Sky": {
            "model_class": "neuralsim_tpu.models.assets.SimpleSkyAsset",
            "model_params": {"hidden": 32},
            "asset_params": {"training_cfg": {"lr": 0.003}},
        },
    },
    "renderer": {"cr_class": "Street", "sky_class": "Sky"},
    "training": {
        "num_iters": 3000,
        "n_rays": 2048,
        "uniform_sample_n": 256,
        "i_log": 100,
        "with_mask": True,
        "losses": {
            "rgb": {"fn_type": "huber", "fn_param": {"delta": 0.1}, "w": 10.0},
            "occupancy_mask": {"w": 0.2},
            "eikonal": {"w": 0.01},
            "latent": {"w": 0.001},
        },
    },
}

WAYMO_STREETSURF: Dict[str, Any] = {
    "exp_dir": "logs/waymo_streetsurf",
    "seed": 42,
    "dataset_cfg": {
        "target": "neuralsim_torch.dataio.waymo_demo.demo_sequence",
        "params": {"n_frames": 8, "H": 80, "W": 120, "n_vehicles": 3, "seed": 0},
    },
    "assetbank_cfg": {
        "Street": {
            "model_class": "neuralsim_tpu.models.assets.LoTDNeuSStreet",
            "model_params": {
                "extend_size": 60.0,
                "encoding_cfg": {"type": "tpu_mixed", "n_levels": 12, "base_res": 16,
                                 "max_res": 4096, "n_feats": 4, "n_hash_levels": 3,
                                 "log2_hashmap_size": 19, "cp_max_res": 1024},
                "geo_feat_dim": 15,
                "radiance_hidden": 64,
                "appear_embed_dim": 4,
                "inv_s_init": 10.0,
                "inv_s_final": 100.0,
                "inv_s_anneal_start_it": 3000,        # num_iters // 5
                "inv_s_anneal_stop_it": 15000,        # num_iters
                "cos_anneal_stop_it": 1000,
                "pretrain": {"type": "road_surface", "up_axis": 2, "n_iters": 500},
                "accel_cfg": {"resolution": 128, "occ_thre": 0.3, "ema_decay": 0.95,
                              "inv_s": 10.0, "n_steps_between_update": 16,
                              "samples_per_voxel": 4},
                "query_cfg": {"num_coarse": 32, "num_fine": [8, 8], "upsample_inv_s": 64.0,
                              "upsample_inv_s_factors": [1.0, 4.0]},
            },
            "asset_params": {
                "training_cfg": {"lr": 0.01, "eps": 1.0e-15, "betas": [0.9, 0.99],
                                 "type": "exponential",
                                 "total_steps": "${training.num_iters}",
                                 "decay_target_factor": 0.1},
            },
        },
        "Distant": {
            "model_class": "neuralsim_tpu.models.assets.LoTDNeRFDistant",
            "model_params": {
                "geometry": "lotd",
                "encoding_cfg": {"n_levels": 10, "base_res": 16, "max_res": 1024,
                                 "log2_hashmap_size": 17},
                "appear_embed_dim": 4,
                "query_cfg": {"num_samples": 32},
            },
            "asset_params": {"training_cfg": {"lr": 0.005}},
        },
        "Sky": {
            "model_class": "neuralsim_tpu.models.assets.SimpleSkyAsset",
            "model_params": {"hidden": 64, "appear_embed_dim": 4},
            "asset_params": {"training_cfg": {"lr": 0.003}},
        },
    },
    "renderer": {"cr_class": "Street", "distant_class": "Distant", "sky_class": "Sky"},
    "training": {
        "num_iters": 15000,
        "n_rays": 8192,
        "n_rays_lidar": 8192,
        "with_mask": True,
        "with_lidar": True,
        "uniform_sample_n": 2048,
        "i_log": 100,
        "i_val": 1500,
        "i_backup": 5000,
        "val_downscale": 4,
        "error_map": {"hw": [32, 64], "frac_uniform": 0.5, "enable_after": 500},
        "losses": {
            "rgb": {"fn_type": "huber", "fn_param": {"delta": 0.1}, "w": 10.0},
            "occupancy_mask": {"w": 0.3},
            "mask_entropy": {"w": 0.005, "mode": "crisp_cr", "enable_after": 1000},
            "eikonal": {"w": 0.01, "on_render_ratio": 0.3},
            "sparsity": {"w": 0.002, "enable_after": 500},
            "clearance": {"w": 0.1, "thresh": 0.001, "beta": 10.0},
            "lidar": {"w": 1.0, "discard_toofar": 120.0, "discard_outliers_median": 100.0,
                      "depth": {"fn_type": "l1_log", "w": 0.1},
                      "line_of_sight": {"fn_type": "neus_unisim", "w": 0.01,
                                        "epsilon": {"type": "milestones",
                                                    "milestones": [3000, 8000],
                                                    "vals": [2.0, 1.0, 0.5]}}},
        },
    },
}

# the top-level keys of the YAML file that SYNTHETIC_OBJECT mirrors
MIRRORED_KEYS = ("seed", "dataset_cfg", "assetbank_cfg", "renderer", "training")

def resolve_refs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """A deep copy of ``cfg`` with every ``${a.b.c}`` and ``${eval:...}``
    resolved (``config.resolve_interpolations``), as plain dicts."""
    return resolve_interpolations(copy.deepcopy(cfg)).to_plain()


def at_num_iters(cfg: Dict[str, Any], num_iters: int) -> Dict[str, Any]:
    """A copy of a config of the demo drive (``WAYMO_DEMO_MULTI`` and its
    variants, ``WAYMO_STREETSURF``) whose schedule spans ``num_iters``
    iterations: the entries that its YAML writes as ``${eval:...}`` of
    ``training.num_iters`` take the values those expressions give. Both YAML
    files anneal a NeuS asset's inv_s from n // 5 to n;
    configs/waymo_demo_multi.yaml also starts its sparsity ramp (the loss
    with an ``anneal``) at n // 10, ramped up to n // 2, and puts the
    line-of-sight epsilon's milestones at n // 3 and 2 n // 3, where
    configs/waymo_streetsurf.yaml writes those as numbers."""
    n = int(num_iters)
    out = copy.deepcopy(cfg)
    out["training"]["num_iters"] = n
    for acfg in out["assetbank_cfg"].values():
        mp = acfg.get("model_params") or {}
        if "inv_s_anneal_stop_it" in mp:
            mp.update(inv_s_anneal_start_it=n // 5, inv_s_anneal_stop_it=n)
    losses = out["training"].get("losses", {})
    if "anneal" in losses.get("sparsity", {}):
        losses["sparsity"]["enable_after"] = n // 10
        losses["sparsity"]["anneal"].update(start_it=n // 10, stop_it=n // 2)
        eps = losses.get("lidar", {}).get("line_of_sight", {}).get("epsilon")
        if isinstance(eps, dict) and eps.get("type") == "milestones":
            eps["milestones"] = [n // 3, 2 * n // 3]
    return out


def load_config(path: str) -> Dict[str, Any]:
    """Read a config file as written, its interpolations unresolved
    (``config.load_config``; PyYAML is imported only for a ``.yaml`` file)."""
    return _load_config(path, resolve=False).to_plain()
