"""Build the renderers, the trainer and seeded parameters from a config dict
(port of neuralsim_tpu/tools/train.py:21-125 ``build_everything``, of the
model that the JAX package's bench.py:56-129 builds by hand, and of the
multi-object set-up in neuralsim_tpu/tools/train_multi.py:18-72, 105-163
and the frame loop of neuralsim_tpu/tools/eval_multi.py:51-60).

Usage::

    from neuralsim_torch.configs import SYNTHETIC_OBJECT
    from neuralsim_torch.tools.build import build_renderer, build_trainer
    renderer, params = build_renderer(SYNTHETIC_OBJECT)          # on the card
    out = renderer.render_chunked(params, rays_o, rays_d, rayschunk=4096)
    trainer, state = build_trainer(SYNTHETIC_OBJECT)             # on the card
    state, metrics = trainer.train_step(state, batch, noise)

``BENCH_OBJECT`` (occupancy grid, distant field, 12 stacked-CP levels) builds
the same way; its trainer's state carries the converged grid, and a render
takes it as ``occ_states=state.occ``.

A single-scene config of a dataset (``WAYMO_STREETSURF``: the street's
NeuS, the 4-D LoTD distant field and the sky on the demo drive; or
configs/waymo_emernerf.yaml, read by ``config.load_config``: EmerNeRF's
street and the sky) goes through
the scene bank, the asset bank and the single-volume renderer, with its
trainer, state and data loader::

    from neuralsim_torch.configs import WAYMO_STREETSURF as C
    scene, bank, renderer, trainer, state, loader = build_everything(C)   # on the card

The multi-object scene (``WAYMO_DEMO_MULTI``) goes through the scene graph,
the asset bank and the compose renderer::

    from neuralsim_torch.configs import WAYMO_DEMO_MULTI as C
    from neuralsim_torch.dataio.waymo_demo import ground_sdf_tensor
    scene, bank, renderer, params = build_compose_renderer(C)    # on the card
    accel = renderer.accels["cr"]
    occ = {"cr": converge_occ(accel, accel.init_state(), ground_sdf_tensor,
                              **C["occ_converge"])}
    out = render_multi_frame(renderer, params, scene, 0, "camera_FRONT", occ)

Training it (``tools/train_multi.py`` runs the loop)::

    scene, bank, trainer, state, samplers = build_multi_trainer(C)   # on the card

``WAYMO_DEMO_CROWD`` (8 vehicles with per-instance occupancy grids, the
pair-budget path) and ``SYNTHETIC_MULTI`` (configs/synthetic_multi.yaml: the
procedural two-sphere scene, ``SyntheticMultiObjectDataset``) build the same
way; a render of the crowd starts from converged vehicle grids::

    veh = renderer.objects[0].model_id
    occ[veh] = converge_occ(renderer.accels[veh], renderer.accels[veh].init_state(),
                            lambda x, b: params[veh].query_sdf(x, bidx=b))
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..accel import OccGridEma, OccGridState
from ..configs import resolve_refs
from ..dataio.synthetic import sdf_scene_tensor
from ..dataio.dataloader import LidarSampler, PixelSampler, SceneDataLoader
from ..dataio.synthetic_multi import SyntheticMultiObjectDataset
from ..dataio.waymo import WaymoDataset
from ..dataio.waymo_demo import demo_scenario, demo_sequence
from ..fields.nerf import NeRFDistantField
from ..fields.neus import NeuSField
from ..fields.sky import SimpleSky
from ..fields.spatial import AABBSpace
from ..models.assets import asset_class
from ..renderers.buffer_compose import BufferComposeRenderer
from ..renderers.single_volume import SingleVolumeRenderer
from ..models.assets import ImageEmbeddings, LearnableParams
from ..scene import AssetBank, Scene
from ..scene.observers import camera_get_all_rays
from ..scene.scene_bank import create_scene_bank
from ..training.error_map import ErrorMap, ImpSampler
from ..training.multi_trainer import MultiObjectTrainer
from ..training.trainer import Trainer, TrainState

FIELDS = {"NeuSField": NeuSField, "NeRFDistantField": NeRFDistantField,
          "SimpleSky": SimpleSky}


def resolve_device(device) -> torch.device:
    """The port runs on the card; the CPU only when asked for explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    return dev


def _from_assets(cfg: Dict[str, Any]):
    """Fields, role binding, query configs and grids of an ``assetbank_cfg``
    config (the YAML route)."""
    assets = {}
    for name, acfg in cfg["assetbank_cfg"].items():
        asset = asset_class(acfg["model_class"])(acfg.get("model_params"))
        asset.populate()
        assets[name] = asset
    rcfg = cfg.get("renderer", {})
    param_keys = {"cr": rcfg.get("cr_class", "Main")}
    if param_keys["cr"] not in assets:
        raise ValueError(f"no close-range asset of class {param_keys['cr']}")
    for role, default in (("sky", "Sky"), ("distant", "Distant")):
        if rcfg.get(f"{role}_class", default) in assets:
            param_keys[role] = rcfg.get(f"{role}_class", default)
    cr = assets[param_keys["cr"]]
    query_cfg = {**cr.query_cfg, **dict(rcfg.get("query_cfg", {}))}
    distant_query_cfg = {**(assets[param_keys["distant"]].query_cfg
                            if "distant" in param_keys else {}),
                         **dict(rcfg.get("distant_query_cfg", {}))}
    accels = {"cr": cr.accel} if cr.accel is not None else {}
    return ({n: a.field for n, a in assets.items()}, param_keys, query_cfg,
            distant_query_cfg, accels)


def _from_models(cfg: Dict[str, Any]):
    """The same for a ``models`` config, which names the fields directly
    (``BENCH_OBJECT``); model ids are the roles."""
    fields = {}
    for role, mcfg in cfg["models"].items():
        params = dict(mcfg.get("params", {}))
        if "aabb" in mcfg:
            params["space"] = AABBSpace(*mcfg["aabb"])
        fields[role] = FIELDS[mcfg["field"]](**params)
    if "cr" not in fields:
        raise ValueError("no close-range model 'cr'")
    rcfg = cfg.get("renderer", {})
    accels = {role: OccGridEma(fields[role].space, **acfg)
              for role, acfg in cfg.get("accel_cfg", {}).items()}
    return (fields, {role: role for role in fields}, dict(rcfg.get("query_cfg", {})),
            dict(rcfg.get("distant_query_cfg", {})), accels)


def build_renderer(cfg: Dict[str, Any], device="cuda"
                   ) -> Tuple[SingleVolumeRenderer, nn.ModuleDict]:
    """-> (renderer, params). ``params`` is an ``nn.ModuleDict`` of the field
    modules keyed by model id, initialised from the config's ``seed`` with the
    JAX init formulas, in distribution. The renderer's occupancy grids
    (``renderer.accels``) come without a state: take the trainer's, or
    ``accel.init_state()`` and :func:`converge_occ`."""
    dev = resolve_device(device)
    fields, param_keys, query_cfg, distant_query_cfg, accels = \
        (_from_models if "models" in cfg else _from_assets)(cfg)
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    params = nn.ModuleDict()
    for name in sorted(fields):
        fields[name].reset_parameters(gen)
        params[name] = fields[name]
    params.to(dev)
    renderer = SingleVolumeRenderer(query_cfg=query_cfg, distant_query_cfg=distant_query_cfg,
                                    param_keys=param_keys, accels=accels)
    return renderer, params


def converge_occ(accel: OccGridEma, state: OccGridState, sdf_fn: Callable[..., torch.Tensor],
                 n: int = 40, it: int = 1000, seed: int = 0) -> OccGridState:
    """``n`` EMA updates of the grid against an SDF (points [P, 3] -> sdf
    [P], on the grid's device: the synthetic scene's ``sdf_scene_tensor``,
    the demo drive's ``ground_sdf_tensor``; for per-instance grids,
    ``OccGridEmaBatched``, points and instance indices [P] -> sdf [P], such
    as a shared model's own ``query_sdf(x, bidx=b)``), so that rendering and
    training start from the grid's steady state (the warm-up of the JAX
    package's ``bench.py``). ``it`` is the iteration the updates see (past
    any warm-up); the voxel jitter comes from ``seed``."""
    dev = state.val.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(n):
        state = accel.update(state, sdf_fn,
                             torch.rand(accel.jitter_shape, generator=gen, device=dev), it)
    return state


def build_trainer(cfg: Dict[str, Any], device="cuda") -> Tuple[Trainer, TrainState]:
    """-> (trainer, state): the renderer of :func:`build_renderer` under the
    config's ``training`` block, with one Adam per model (from the asset's
    ``asset_params.training_cfg``, ``${training.num_iters}`` resolved, or from
    ``training.optim`` of a ``models`` config). With ``occ_converge`` in the
    config the occupancy grid starts converged (:func:`converge_occ`)."""
    cfg = resolve_refs(cfg)
    renderer, params = build_renderer(cfg, device)
    tcfg = cfg.get("training", {})
    if "models" in cfg:
        training_cfgs, default = dict(tcfg.get("optim", {})), None
    else:
        training_cfgs = {name: dict(acfg.get("asset_params", {}).get("training_cfg", {}))
                         for name, acfg in cfg["assetbank_cfg"].items()}
        default = dict(tcfg.get("optim", {"lr": 1e-2}))
    trainer = Trainer(renderer, loss_cfgs=dict(tcfg.get("losses", {})),
                      training_cfgs=training_cfgs,
                      uniform_sample_n=tcfg.get("uniform_sample_n", 1024),
                      default_optim_cfg=default)
    state = trainer.init_state(params)
    if "occ_converge" in cfg and state.occ:
        for role, accel in renderer.accels.items():
            state.occ[role] = converge_occ(accel, state.occ[role], sdf_scene_tensor,
                                           seed=int(cfg.get("seed", 0)), **cfg["occ_converge"])
    return trainer, state


# the Waymo reader's params, which a config of a Waymo sequence keeps beside a
# command line's dot override of the target by the in-memory demo drive
# (overrides merge into the YAML's params); the demo drive reads none of them
_WAYMO_READER_PARAMS = ("root", "camera_list", "lidar_list")


def _dataset_target(cfg: Dict[str, Any], allowed: Tuple[str, ...], path: str
                    ) -> Tuple[str, Dict[str, Any]]:
    """(the last part of the dataset target's name, its params): the target
    is told by that name and never imported, so the YAMLs' targets in the JAX
    package name the port's datasets; another name raises, naming ``path``."""
    ds = cfg["dataset_cfg"]
    name = ds["target"].rsplit(".", 1)[-1]
    if name not in allowed:
        raise NotImplementedError(f"dataset {ds['target']} is not ported for the {path} "
                                  "build, which reads " + ", ".join(allowed))
    params = dict(ds.get("params", {}))
    if name in ("demo_scenario", "demo_sequence"):
        params = {k: v for k, v in params.items() if k not in _WAYMO_READER_PARAMS}
    return name, params


def _make_dataset(name: str, params: Dict[str, Any]):
    if name == "WaymoDataset":
        return WaymoDataset(**params)
    if name == "SyntheticMultiObjectDataset":
        return SyntheticMultiObjectDataset(**params)
    return demo_sequence(**params)


def first_scenario(dataset, cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The scenario of a multi-object config: ``scenebank_cfg.scenarios``'s
    first scene, else the dataset's first."""
    sid = (cfg.get("scenebank_cfg", {}).get("scenarios") or [None])[0]
    return dataset.get_scenario(sid or dataset.scene_ids()[0])


def single_dataset(cfg: Dict[str, Any]):
    """The dataset of a single-scene config by its target: a sequence in the
    Waymo layout on disk (``WaymoDataset``, all its params: ``root``,
    ``sequences``, ``camera_list``, ``lidar_list``, the dir names) or the
    demo drive's sequence in memory (``demo_sequence``, its params less the
    Waymo reader's)."""
    return _make_dataset(*_dataset_target(cfg, ("WaymoDataset", "demo_sequence"),
                                          "single-scene"))


def build_everything(cfg: Dict[str, Any], device="cuda",
                     timings: Optional[Dict[str, float]] = None, pretrain: bool = True,
                     exp_dir: Optional[str] = None):
    """-> (scene, bank, renderer, trainer, state, loader) of a single-scene
    config, as the JAX tool's ``build_everything``: its dataset
    (:func:`single_dataset`) and scene (``scene.scene_bank.create_scene_bank``
    with ``scenebank_cfg``, its scenario pickled under ``exp_dir`` where
    given), the asset bank, the renderer's roles bound by class
    (``renderer.cr_class``, ``distant_class``, ``sky_class``; the distant
    field's shells around the close-range box where it has none of its own),
    the close range's occupancy grid (unless ``renderer.use_occ_accel`` is
    false), the bank's parameters seeded from ``seed``, each asset's geometry
    pretraining (the street's road surface; its uniform draws from a
    generator seeded with ``seed + 1`` on the device; left out with
    ``pretrain=False``), the :class:`Trainer` with the scene and an
    ``ImageEmbeddings`` asset as its ``embed_model`` and a ``LearnableParams``
    asset as its pose model (from its ``enable_after``), its state (the grid at
    ``init_state``) and the ``SceneDataLoader``. As in the JAX tool the
    distant ladder takes ``renderer.distant_query_cfg`` (by default 64
    samples), not the distant asset's ``query_cfg``. ``timings``, where
    given, receives the seconds of each part."""
    import time
    timings = {} if timings is None else timings
    cfg = resolve_refs(cfg)
    dev = resolve_device(device)
    tcfg = cfg.get("training", {})
    seed = int(cfg.get("seed", 0))

    t0 = time.perf_counter()
    dataset = single_dataset(cfg)
    scene = create_scene_bank(dataset, dict(cfg.get("scenebank_cfg", {})), exp_dir=exp_dir,
                              device=dev)[0]
    timings["sequence_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bank = AssetBank.create(cfg["assetbank_cfg"], [scene])
    rcfg = cfg.get("renderer", {})
    param_keys: Dict[str, str] = {}
    assets = {}
    for role, default in (("cr", "Main"), ("distant", "Distant"), ("sky", "Sky")):
        cls_name = rcfg.get(f"{role}_class", default)
        for mid, asset in bank.assets.items():
            if bank.class_of[mid] == cls_name and asset.field is not None:
                param_keys[role], assets[role] = mid, asset
                break
    if "cr" not in assets:
        raise ValueError(f"no close-range asset of class {rcfg.get('cr_class', 'Main')}")
    cr_asset = assets["cr"]
    dv = assets.get("distant")
    if dv is not None and getattr(dv.field, "cub_center", 0) is None:
        dv.field.set_cr_aabb(cr_asset.field.space)
    accels = {"cr": cr_asset.accel} \
        if cr_asset.accel is not None and rcfg.get("use_occ_accel", True) else {}
    renderer = SingleVolumeRenderer(
        query_cfg={**cr_asset.query_cfg, **dict(rcfg.get("query_cfg", {}))},
        distant_query_cfg=dict(rcfg.get("distant_query_cfg", {})),
        param_keys=param_keys, accels=accels)
    params = bank.init_params(torch.Generator().manual_seed(seed), dev)
    timings["bank_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if pretrain:
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        bank.training_initialize({mid: torch.rand(shape, generator=gen, device=dev)
                                  for mid, shape in bank.pretrain_shapes().items()})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    timings["pretrain_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    embed = [(a, mid) for mid, a in bank.assets.items() if isinstance(a, ImageEmbeddings)]
    pose = [(mid, a.enable_after) for mid, a in bank.assets.items()
            if isinstance(a, LearnableParams)]
    pose_model_id, pose_enable_after = pose[-1] if pose else (None, 0)
    trainer = Trainer(renderer, loss_cfgs=dict(tcfg.get("losses", {})),
                      training_cfgs=bank.training_cfgs(),
                      uniform_sample_n=tcfg.get("uniform_sample_n", 1024),
                      default_optim_cfg=dict(tcfg.get("optim", {"lr": 1e-2})),
                      scene=scene, pose_model_id=pose_model_id,
                      pose_enable_after=pose_enable_after,
                      embed_model=embed[0] if embed else None,
                      debug_grads=bool(tcfg.get("debug_grads", False)),
                      use_ts_interp=bool(tcfg.get("use_ts_interp", False)))
    state = trainer.init_state(params)
    loader = SceneDataLoader(scene, dataset, with_mask=tcfg.get("with_mask", True),
                             with_lidar=tcfg.get("with_lidar", False),
                             filter_lidar_in_cams=tcfg.get("filter_lidar_in_cams", False),
                             filter_lidar_max_range=tcfg.get("filter_lidar_max_range", 0.0))
    timings["trainer_s"] = time.perf_counter() - t0
    return scene, bank, renderer, trainer, state, loader


_MULTI_DATASETS = ("WaymoDataset", "demo_scenario", "demo_sequence",
                   "SyntheticMultiObjectDataset")


def multi_scenario(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The scenario of a multi-object config's dataset (all a render needs):
    ``WaymoDataset``'s sequence on disk (:func:`first_scenario`), the demo
    drive's (``demo_scenario``, in memory) or ``SyntheticMultiObjectDataset``'s."""
    name, params = _dataset_target(cfg, _MULTI_DATASETS, "multi-object")
    if name in ("demo_scenario", "demo_sequence"):
        return demo_scenario(**params)
    return first_scenario(_make_dataset(name, params), cfg)


def multi_dataset(cfg: Dict[str, Any]):
    """The dataset of a multi-object config with its data, for the data
    loader: a sequence in the Waymo layout on disk (``WaymoDataset``), the
    demo drive's sequence in memory (``demo_scenario``, ``demo_sequence``:
    images, masks, LiDAR) or ``SyntheticMultiObjectDataset``."""
    return _make_dataset(*_dataset_target(cfg, _MULTI_DATASETS, "multi-object"))


def build_compose_renderer(cfg: Dict[str, Any], device="cuda", scenario=None
                           ) -> Tuple[Scene, AssetBank, BufferComposeRenderer, nn.ModuleDict]:
    """-> (scene, bank, renderer, params) of a multi-object config: the
    scenario -> ``Scene.load_from_scenario`` -> ``AssetBank.create`` ->
    ``BufferComposeRenderer.from_asset_bank``, with the ``renderer`` block's
    settings, and the bank's parameters seeded from the config's ``seed``.
    The scenario is the config's dataset's (:func:`multi_scenario`), or
    ``scenario`` where the caller built it. The occupancy grids
    (``renderer.accels``: the street's under "cr", a shared model's
    per-instance grids under its model id) come without a state: converge
    them with :func:`converge_occ`."""
    dev = resolve_device(device)
    if scenario is None:
        scenario = multi_scenario(cfg)
    scene = Scene.load_from_scenario(scenario, device=dev)
    bank = AssetBank.create(cfg["assetbank_cfg"], [scene])
    rcfg = cfg.get("renderer", {})
    renderer = BufferComposeRenderer.from_asset_bank(
        scene, bank, obj_query_cfg=dict(rcfg.get("obj_query_cfg", {})),
        cr_class=rcfg.get("cr_class", "Street"), distant_class=rcfg.get("distant_class", "Distant"),
        sky_class=rcfg.get("sky_class", "Sky"),
        hit_budget_frac=rcfg.get("hit_budget_frac", 0.5),
        group_budget_frac=rcfg.get("group_budget_frac", 1.0),
        max_hits_per_ray=rcfg.get("max_hits_per_ray", 4))
    params = bank.init_params(torch.Generator().manual_seed(int(cfg.get("seed", 0))), dev)
    return scene, bank, renderer, params


def render_multi_frame(renderer: BufferComposeRenderer, params: nn.ModuleDict, scene: Scene,
                       fi: int, cam_id: str, occ_states: Optional[Dict[str, Any]] = None,
                       rayschunk: int = 4096) -> Dict[str, Any]:
    """One camera frame of the scene at frame ``fi``: freeze the scene, the
    camera's full ray grid, the chunked deterministic compose render (the
    volumes and ``per_obj``, [H * W] rows in row order)."""
    frozen = scene.slice_at(fi)
    H, W = (int(v) for v in scene.nodes[cam_id].frame_data["hw"][fi].tolist())
    rays_o, rays_d = camera_get_all_rays(frozen, cam_id, H, W)
    return renderer.render_chunked(params, frozen, rays_o, rays_d, rayschunk=rayschunk,
                                   occ_states=occ_states)


def build_multi_trainer(cfg: Dict[str, Any], device="cuda",
                        timings: Optional[Dict[str, float]] = None, pretrain: bool = True):
    """-> (scene, bank, trainer, state, samplers) of a multi-object config:
    its dataset (:func:`multi_dataset`: a Waymo-layout sequence on disk, the
    demo drive's scenario, images, masks and LiDAR in memory, or the
    synthetic multi-object scene) and its scenario (:func:`first_scenario`), the
    compose renderer and the bank's seeded parameters
    (:func:`build_compose_renderer`), each asset's geometry pretraining (the
    street's road surface; its uniform draws from a generator seeded with
    ``seed + 1`` on the device), a :class:`MultiObjectTrainer` with one Adam
    per model (``asset_params.training_cfg``), its state with the street's
    grids at ``init_state`` (not converged, as in the JAX package's training),
    and ``samplers`` {"pixel": PixelSampler (with the ``training.error_map``
    importance sampler), "lidar": LidarSampler or None, "imp": ImpSampler or
    None}. ``timings``, where given, receives the seconds of each part.
    ``pretrain=False`` leaves the geometry pretraining out: for a state that
    a checkpoint then overwrites (the evaluation tools)."""
    import time
    timings = {} if timings is None else timings
    cfg = resolve_refs(cfg)
    if any(asset_class(c["model_class"]) is LearnableParams
           for c in cfg["assetbank_cfg"].values()):
        raise NotImplementedError("pose refinement (LearnableParams) is not ported in the "
                                  "multi-object trainer")
    dev = resolve_device(device)
    tcfg = cfg.get("training", {})
    seed = int(cfg.get("seed", 0))

    t0 = time.perf_counter()
    seq = multi_dataset(cfg)
    scenario = first_scenario(seq, cfg)
    timings["sequence_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene, bank, renderer, params = build_compose_renderer(cfg, dev, scenario=scenario)
    timings["bank_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if pretrain:
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        bank.training_initialize({mid: torch.rand(shape, generator=gen, device=dev)
                                  for mid, shape in bank.pretrain_shapes().items()})
    if dev.type == "cuda":
        torch.cuda.synchronize()
    timings["pretrain_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    trainer = MultiObjectTrainer(scene, renderer, loss_cfgs=dict(tcfg.get("losses", {})),
                                 training_cfgs=bank.training_cfgs(),
                                 uniform_sample_n=tcfg.get("uniform_sample_n", 256),
                                 debug_grads=bool(tcfg.get("debug_grads", False)),
                                 use_ts_interp=bool(tcfg.get("use_ts_interp", False)))
    state = trainer.init_state(params)
    for name in ("image_patch", "data_parallel"):
        if tcfg.get(name):
            raise NotImplementedError(f"training.{name} is not ported")
    loader = SceneDataLoader(scene, seq, with_mask=tcfg.get("with_mask", True),
                             with_lidar=tcfg.get("with_lidar", False),
                             filter_lidar_in_cams=tcfg.get("filter_lidar_in_cams", False),
                             filter_lidar_max_range=tcfg.get("filter_lidar_max_range", 0.0))
    em = tcfg.get("error_map", {})
    imp = ImpSampler(ErrorMap(scene.n_frames, tuple(em.get("hw", (32, 64)))),
                     frac_uniform=em.get("frac_uniform", 0.5),
                     enable_after=em.get("enable_after", 0)) if em else None
    samplers = {"pixel": PixelSampler(loader, n_rays=tcfg.get("n_rays", 2048), seed=seed,
                                      imp_sampler=imp),
                "lidar": LidarSampler(loader, n_rays=tcfg.get("n_rays_lidar", 2048))
                if tcfg.get("with_lidar") else None,
                "imp": imp}
    timings["trainer_s"] = time.perf_counter() - t0
    return scene, bank, trainer, state, samplers
