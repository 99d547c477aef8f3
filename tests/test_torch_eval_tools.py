"""Port parity for the pieces of the evaluation tools, against
``neuralsim_tpu`` on the CPU: the image metrics (``psnr_np``, ``ssim_np``),
``chamfer_distance`` with every trim, the whole-frame sampler, the demo
sequence's semantic mask, ``NeuSField.forward_inv_s`` at a checkpoint's
iteration, the schedule at another length (``configs.at_num_iters`` against
the YAML's expressions), and the scoring of ``evaluate_multi`` and
``eval_lidar_frames`` on a stub renderer that returns the same arrays to both
packages.

Tolerances. The metrics are the same float64 numpy and scipy code in both:
equal. ``chamfer_distance`` runs in float32 in both (a sum of three squares,
a square root, a mean or a quantile cut): 1e-6 relative (measured <= 2.3e-7).
The sampler, the semantic masks, the schedule and the frame scoring are
equal. The LiDAR scoring lifts the beams to world rays in each package: its
depth errors, counts and miss fractions are equal, its chamfer distances
within the same 1e-6 (measured <= 2.3e-7).
"""
import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from neuralsim_tpu.config import load_config
from neuralsim_tpu.dataio.dataloader import ImageSampler as JaxImageSampler
from neuralsim_tpu.dataio.dataloader import SceneDataLoader as JaxLoader
from neuralsim_tpu.dataio.waymo import WaymoDataset
from neuralsim_tpu.dataio.waymo_demo import build_demo_sequence
from neuralsim_tpu.fields.neus import NeuSField as JaxNeuS
from neuralsim_tpu.maths.common import chamfer_distance as jax_chamfer
from neuralsim_tpu.maths.metrics import psnr_np as jax_psnr, ssim_np as jax_ssim
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.tools.eval_lidar import eval_lidar_frames as jax_eval_lidar
from neuralsim_tpu.tools.eval_multi import evaluate_multi as jax_evaluate
from neuralsim_torch.configs import WAYMO_DEMO_MULTI, at_num_iters
from neuralsim_torch.dataio.dataloader import ImageSampler, SceneDataLoader
from neuralsim_torch.dataio.waymo_demo import demo_sequence
from neuralsim_torch.fields.neus import NeuSField
from neuralsim_torch.maths.common import chamfer_distance
from neuralsim_torch.maths.metrics import lpips_np, psnr_np, ssim_np
from neuralsim_torch.scene import Scene
from neuralsim_torch.tools.eval_lidar import eval_lidar_frames
from neuralsim_torch.tools.eval_multi import evaluate_multi
from neuralsim_torch.utils.misc import set_eval_iteration

torch.set_num_threads(1)

DRIVE = dict(n_frames=4, H=24, W=40, n_vehicles=3, seed=0)
CHAMFER_REL = 1e-6
KINDS = ("all", "sky", "human", "vehicle", "dynamic")


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, shape)
    pred = np.clip(gt + rng.normal(0, 0.05, shape), 0, 1)
    return pred.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("shape", [(24, 40, 3), (31, 17, 3), (24, 40), (300, 3)])
def test_psnr_and_ssim_equal_jax(shape):
    pred, gt = _images(len(shape), shape)
    assert psnr_np(pred, gt) == jax_psnr(pred, gt)
    assert psnr_np(gt, gt) == jax_psnr(gt, gt) == 99.0
    assert ssim_np(pred, gt) == jax_ssim(pred, gt)


def test_lpips_is_none_without_weights_and_raises_with_them():
    pred, gt = _images(0, (8, 8, 3))
    assert lpips_np(pred, gt) is None
    with pytest.raises(NotImplementedError, match="lpips_np"):
        lpips_np(pred, gt, "vgg16.pt")


@pytest.mark.parametrize("n,m", [(700, 768), (5000, 300), (1, 9)])
@pytest.mark.parametrize("trim", [None, 0.99, 0.97, 0.95])
def test_chamfer_distance_matches_jax(n, m, trim):
    rng = np.random.default_rng(n + m)
    a = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    b = (rng.uniform(-20, 20, (m, 3)) * [1.0, 1.0, 0.1]).astype(np.float32)
    a[: n // 10] = b[: n // 10] if n // 10 <= m else a[: n // 10]   # some exact matches
    got = chamfer_distance(torch.from_numpy(a), torch.from_numpy(b), trim_quantile=trim)
    want = jax_chamfer(jnp.asarray(a), jnp.asarray(b), trim_quantile=trim)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=CHAMFER_REL)


@pytest.fixture(scope="module")
def seq():
    return demo_sequence(**DRIVE)


@pytest.fixture(scope="module")
def jax_reader(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    build_demo_sequence(str(root), **DRIVE)
    return WaymoDataset(str(root))


@pytest.mark.parametrize("kind", KINDS)
def test_semantic_mask_matches_the_jax_reader(seq, jax_reader, kind):
    """The demo sequence's semantic ids and masks of each kind equal what the
    JAX package's reader returns from its writer's files."""
    sid = jax_reader.scene_ids()[0]
    for fi in range(DRIVE["n_frames"]):
        got = seq.get_semantic_mask(sid, "camera_FRONT", fi, kind)
        want = jax_reader.get_semantic_mask(sid, "camera_FRONT", fi, kind)
        assert got.dtype == want.dtype and got.shape == (DRIVE["H"], DRIVE["W"])
        np.testing.assert_array_equal(got, want)
    assert seq.get_semantic_mask(sid, "camera_FRONT", 99) is None


@pytest.fixture(scope="module")
def scenes(seq):
    return Scene.load_from_scenario(seq.scenario), JaxScene.load_from_scenario(seq.scenario)


@pytest.fixture(scope="module")
def loaders(seq, scenes, jax_reader):
    """The port's loader over the sequence in memory, and the JAX package's
    over the same frames with the JAX reader as its dataset (where the
    evaluation reads the semantic mask)."""
    mine = SceneDataLoader(scenes[0], seq, with_lidar=True)
    theirs = JaxLoader(scenes[1], seq, with_lidar=True)
    theirs.dataset = jax_reader
    return mine, theirs


@pytest.mark.parametrize("downscale", [1, 2, 3])
def test_image_sampler_matches_jax(loaders, downscale):
    for fi in (0, 3):
        got = ImageSampler(loaders[0], downscale).get("camera_FRONT", fi)
        want = JaxImageSampler(loaders[1], downscale).get("camera_FRONT", fi)
        assert set(got) == set(want) and got["hw"] == want["hw"]
        for k in ("rays_xy", "image_rgb", "image_occupancy_mask"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _field_pair(**kw):
    enc = {"type": "tpu_mixed", "n_levels": 2, "base_res": 4, "max_res": 8, "n_feats": 2,
           "n_hash_levels": 0}
    jf = JaxNeuS(encoding_cfg=enc, ln_inv_s_init=math.log(10.0), **kw)
    jp = jf.init(jax.random.PRNGKey(0))
    jp["ln_inv_s"] = jnp.asarray(math.log(13.0), jnp.float32)
    pf = NeuSField(encoding_cfg=enc, ln_inv_s_init=math.log(10.0), **kw)
    with torch.no_grad():
        pf.ln_inv_s.fill_(math.log(13.0))
    return jf, jp, pf


@pytest.mark.parametrize("eval_it", [None, 0, 1000, 3000, 5999, 6000, 9000])
def test_forward_inv_s_reads_the_checkpoint_iteration_as_jax(eval_it):
    """A render (``it`` None) of a field stamped with a checkpoint's
    iteration mixes inv_s as the JAX field does; unstamped, both take the
    anneal's end."""
    jf, jp, pf = _field_pair(inv_s_final=30.0, inv_s_anneal_start_it=1200,
                             inv_s_anneal_stop_it=6000)
    if eval_it is not None:
        jf.eval_it = eval_it
        set_eval_iteration([pf, None], eval_it)
    with torch.no_grad():
        got, at_3000 = float(pf.forward_inv_s()), float(pf.forward_inv_s(3000))
    want = float(jf.forward_inv_s(jp))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if eval_it is not None and eval_it < 6000:
        assert got < 30.0
    np.testing.assert_allclose(at_3000, float(jf.forward_inv_s(jp, 3000)), rtol=1e-6)


@pytest.mark.parametrize("n", [3, 7, 48, 600, 6000, 12345])
def test_schedule_at_another_length_matches_the_yaml(n):
    want = load_config("configs/waymo_demo_multi.yaml", [f"training.num_iters={n}"])
    got = at_num_iters(WAYMO_DEMO_MULTI, n)
    for k in ("assetbank_cfg", "renderer", "training"):
        assert got[k] == want[k], k
    assert got["dataset_cfg"] == WAYMO_DEMO_MULTI["dataset_cfg"]
    assert at_num_iters(WAYMO_DEMO_MULTI, 6000) == WAYMO_DEMO_MULTI


class _StubCompose:
    """A compose renderer that returns the next of ``frames`` (seeded arrays
    [H W]) for each frame, as numpy (the JAX package) or torch tensors."""

    def __init__(self, frames, torch_out):
        self.frames, self.torch_out, self.calls = list(frames), torch_out, []

    def _out(self, a):
        return torch.from_numpy(a) if self.torch_out else a

    def render_chunked(self, params, frozen, ro, rd, **kw):
        self.calls.append(sorted(kw))
        f = self.frames.pop(0)
        out = {k: self._out(v) for k, v in f.items() if k != "per_obj"}
        out["per_obj"] = {n: {k: self._out(v) for k, v in sub.items()}
                          for n, sub in f["per_obj"].items()}
        return out

    def ray_query(self, params, ro, rd, **kw):
        self.calls.append(sorted(kw))
        f = self.frames.pop(0)
        return {k: self._out(v) for k, v in f.items()}


def _stub_frames(n_frames, n, sources, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    out = []
    for _ in range(n_frames):
        per_obj = {s: {"rgb_volume": f32(n, 3), "depth_volume": f32(n) * 40,
                       "mask_volume": f32(n) ** (4 if s.startswith("veh") else 1)}
                   for s in sources}
        out.append({"rgb_volume": f32(n, 3), "depth_volume": f32(n) * 40,
                    "mask_volume": f32(n), "normals_volume": f32(n, 3), "per_obj": per_obj})
    return out


@pytest.mark.parametrize("downscale", [1, 2])
def test_frame_scoring_equals_jax(scenes, loaders, tmp_path, downscale):
    """The same rendered arrays scored by both packages' ``evaluate_multi``:
    every metric, the ground (road) ownership from the semantic mask, the
    aggregates and the first frame's images are equal."""
    frames = [0, 2, 3]
    H, W = (-(-DRIVE["H"] // downscale), -(-DRIVE["W"] // downscale))
    sources = ["distant", "street", "veh_0", "veh_1", "veh_2"]
    stub = _stub_frames(len(frames), H * W, sources, downscale)
    (mine, jmine), (scene, jscene) = loaders, scenes
    params = nn.ModuleDict({"m": nn.Linear(1, 1)})
    (tmp_path / "port").mkdir(), (tmp_path / "jax").mkdir()
    got = evaluate_multi(scene, _StubCompose(stub, True), params, mine, cam_id="camera_FRONT",
                         frames=frames, downscale=downscale, out_dir=str(tmp_path / "port"))
    want = jax_evaluate(jscene, _StubCompose(copy.deepcopy(stub), False), None, jmine,
                        cam_id="camera_FRONT", frames=frames, downscale=downscale,
                        out_dir=str(tmp_path / "jax"))
    assert got == want
    assert {o["class"] for o in got["per_object"]} == {"Vehicle", "street", "distant"}
    assert all("road_vis_mass" in o for o in got["per_object"])
    assert got["per_class"]["street"]["road_vis_mass"] > 0
    # the images the JAX package writes as valid PNGs (rgb, gt, each source's
    # rgb) are the same bytes; its depth image is written from floats
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in names:
        if not name.startswith("depth"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name


def test_lidar_scoring_matches_jax(scenes, loaders):
    """The same rendered beams scored by both packages' ``eval_lidar_frames``
    (mask and depth seeded about the ground truth: hits, misses inside and
    outside the street's box)."""
    (mine, jmine), (scene, jscene) = loaders, scenes
    rng = np.random.default_rng(5)
    frames, stub = [0, 1, 3], []
    for fi in frames:
        r = mine.lidars[("lidar_TOP", fi)]["ranges"]
        stub.append({"depth_volume": (r + rng.normal(0, 0.3, r.shape)).astype(np.float32),
                     "mask_volume": rng.uniform(0, 1, r.shape).astype(np.float32)})
    aabb = (np.array([-8.0, -35.0, -0.8], np.float32), np.array([20.0, 35.0, 7.0], np.float32))
    params = nn.ModuleDict({"m": nn.Linear(1, 1)})
    got = eval_lidar_frames(scene, _StubCompose(stub, True), params, mine, frames=frames,
                            cr_aabb=aabb)
    want = jax_eval_lidar(jscene, _StubCompose(copy.deepcopy(stub), False), None, jmine,
                          frames=frames, cr_aabb=aabb)
    assert len(got["per_frame"]) == len(want["per_frame"]) == 3
    for g, w in zip(got["per_frame"] + [got["mean"]], want["per_frame"] + [want["mean"]]):
        assert set(g) == set(w)
        for k, v in w.items():
            if k.startswith("chamfer"):
                np.testing.assert_allclose(g[k], v, rtol=CHAMFER_REL, err_msg=k)
            else:
                assert g[k] == v, k
    assert 0 < got["mean"]["miss_in_cuboid_frac"] and 0 < got["mean"]["miss_out_cuboid_frac"]
