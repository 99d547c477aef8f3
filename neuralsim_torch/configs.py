"""Config dicts for the port, so it runs where PyYAML is missing.

``SYNTHETIC_OBJECT`` mirrors configs/synthetic_object.yaml (dataset, asset
bank, renderer and training keys): NeuS object reconstruction on the
procedural synthetic scene, an LoTD of 6 stacked-CP and 2 hash levels and a
sky MLP. ``${a.b}`` references stay as written, as in the YAML;
:func:`resolve_refs` replaces them.
"""
from __future__ import annotations

import copy
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
