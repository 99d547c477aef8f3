"""Build the renderer, the trainer and seeded parameters from a config dict
(port of the role binding and trainer set-up in
neuralsim_tpu/tools/train.py:49-115, without the scene graph and asset bank).

Usage::

    from neuralsim_torch.configs import SYNTHETIC_OBJECT
    from neuralsim_torch.tools.build import build_renderer, build_trainer
    renderer, params = build_renderer(SYNTHETIC_OBJECT)          # on the card
    out = renderer.render_chunked(params, rays_o, rays_d, rayschunk=4096)
    trainer, state = build_trainer(SYNTHETIC_OBJECT)             # on the card
    state, metrics = trainer.train_step(state, batch, noise)
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..configs import resolve_refs
from ..models.assets import asset_class
from ..renderers.single_volume import SingleVolumeRenderer
from ..training.trainer import Trainer, TrainState


def resolve_device(device) -> torch.device:
    """The port runs on the card; the CPU only when asked for explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


def build_renderer(cfg: Dict[str, Any], device="cuda"
                   ) -> Tuple[SingleVolumeRenderer, nn.ModuleDict]:
    """-> (renderer, params). ``params`` is an ``nn.ModuleDict`` of the field
    modules keyed by asset class name, initialised from the config's ``seed``
    with the JAX init formulas, in distribution."""
    dev = resolve_device(device)
    assets = {}
    for name, acfg in cfg["assetbank_cfg"].items():
        asset = asset_class(acfg["model_class"])(acfg.get("model_params"))
        asset.populate()
        assets[name] = asset
    rcfg = cfg.get("renderer", {})
    param_keys = {"cr": rcfg.get("cr_class", "Main")}
    if param_keys["cr"] not in assets:
        raise ValueError(f"no close-range asset of class {param_keys['cr']}")
    sky = rcfg.get("sky_class", "Sky")
    if sky in assets:
        param_keys["sky"] = sky
    if rcfg.get("distant_class", "Distant") in assets:
        raise NotImplementedError("the distant field is not ported")

    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    params = nn.ModuleDict()
    for name in sorted(assets):
        assets[name].field.reset_parameters(gen)
        params[name] = assets[name].field
    params.to(dev)
    renderer = SingleVolumeRenderer(
        query_cfg={**assets[param_keys["cr"]].query_cfg, **dict(rcfg.get("query_cfg", {}))},
        param_keys=param_keys)
    return renderer, params


def build_trainer(cfg: Dict[str, Any], device="cuda") -> Tuple[Trainer, TrainState]:
    """-> (trainer, state): the renderer of :func:`build_renderer` under the
    config's ``training`` block, with one Adam per asset from its
    ``asset_params.training_cfg`` (``${training.num_iters}`` resolved)."""
    cfg = resolve_refs(cfg)
    renderer, params = build_renderer(cfg, device)
    tcfg = cfg.get("training", {})
    training_cfgs = {name: dict(acfg.get("asset_params", {}).get("training_cfg", {}))
                     for name, acfg in cfg["assetbank_cfg"].items()}
    trainer = Trainer(renderer, loss_cfgs=dict(tcfg.get("losses", {})),
                      training_cfgs=training_cfgs,
                      uniform_sample_n=tcfg.get("uniform_sample_n", 1024),
                      default_optim_cfg=dict(tcfg.get("optim", {"lr": 1e-2})))
    return trainer, trainer.init_state(params)
