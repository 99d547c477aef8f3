"""Config dicts for the port, so it runs where PyYAML is missing.

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
resolved, at ``num_iters`` 6,000. Its dataset is the in-memory demo scenario
(``dataio/waymo_demo.demo_scenario``, the generator's defaults) in place of
the files that ``neuralsim_tpu.dataio.waymo_demo`` writes; ``occ_converge``
is the street grid's warm-up against the drive's static ground.

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
import re
from typing import Any, Dict

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

# the top-level keys of the YAML file that SYNTHETIC_OBJECT mirrors
MIRRORED_KEYS = ("seed", "dataset_cfg", "assetbank_cfg", "renderer", "training")

_REF = re.compile(r"^\$\{([\w.]+)\}$")


def resolve_refs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """A deep copy of ``cfg`` in which every string value ``${a.b.c}`` is
    replaced by the value at that dotted path of ``cfg``."""
    root = copy.deepcopy(cfg)

    def lookup(path: str) -> Any:
        node: Any = root
        for key in path.split("."):
            node = node[key]
        return node

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        m = _REF.match(node) if isinstance(node, str) else None
        return walk(lookup(m.group(1))) if m else node

    return walk(root)


def load_config(path: str) -> Dict[str, Any]:
    """Read a YAML config (PyYAML is imported only here)."""
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)
