"""Port parity for pose refinement against the JAX package on the CPU: the
quaternion maths, ``LearnableParams.apply_delta`` and ``apply_intr_delta``,
the scene graph sliced and interpolated with deltas (``slice_at``,
``interp_at``, ``sensor_ts`` with a holistic and a per-frame ``dts``), the
plain K3's gradient to the positions, and EmerNeRF's training step with a
``Pose`` asset: the first step's losses and every gradient leaf in both lifts
(frame slicing and timestamp mode), then three steps with ``enable_after`` 1.

The scene is the demo drive's scenario (8 frames, the camera a child of the
ego car, ``global_ts`` 0.1 s apart) loaded by both packages. The deltas are
seeded, small and non-zero (1e-3 rad, 1 cm, 0.5 px, 10 ms), so that the
smoothed norm of the rotation delta is away from zero; the zero deltas of a
fresh asset are held apart. The field is tests/test_torch_emernerf.py's
narrow EmerNeRF (a 4-level LoTD of two dense and two hash levels, a 3-level
permuto lattice, MLPs of 16) in the box of the camera track widened by 8 m (so that the sky shows),
its tables moved off their init; 48 rays of random pixels and frames, 12
coarse samples, the YAML's losses.

Tolerances: values rtol 1e-5 / atol 1e-6 (the same float32 operations in
another order); gradients 1e-4 of each leaf's largest entry; loss terms
rtol 1e-4; after one and after three steps every parameter within one lr of
JAX's on all but 0.5% of each leaf's entries and within 6 lr everywhere, each
Adam count equal (tests/test_torch_emernerf.py's bounds). JAX's step is
jitted once a mode (the default compile holds to these bounds; the eager step
takes minutes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from neuralsim_tpu.fields import AABBSpace as JaxSpace
from neuralsim_tpu.fields import SimpleSky as JaxSky
from neuralsim_tpu.fields.emernerf import EmerNeRFField as JaxEmerNeRF
from neuralsim_tpu.fields.encodings.lotd import LoTDEncoding as JaxLoTD
from neuralsim_tpu.maths import transforms as jtf
from neuralsim_tpu.models.assets import LearnableParams as JaxLP
from neuralsim_tpu.renderers import SingleVolumeRenderer as JaxRenderer
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.training import Trainer as JaxTrainer
from neuralsim_torch.bridge import load_jax_params, named_jax_leaves
from neuralsim_torch.dataio.waymo_demo import demo_scenario
from neuralsim_torch.fields.emernerf import EmerNeRFField
from neuralsim_torch.fields.encodings.lotd import (LoTDEncoding, lotd_grid_bwd_x,
                                                   lotd_grid_bwd_x_plain)
from neuralsim_torch.fields.sky import SimpleSky
from neuralsim_torch.fields.spatial import AABBSpace
from neuralsim_torch.maths import transforms as tf
from neuralsim_torch.models.assets import LearnableParams, LoTDNeuSStreet
from neuralsim_torch.renderers.single_volume import SingleVolumeRenderer
from neuralsim_torch.scene import Scene
from neuralsim_torch.training.trainer import Trainer

torch.set_num_threads(1)

N_RAYS, NC, N_FLOW = 48, 12, 40
CAM = "camera_FRONT"
POSE_MP = {"refine_nodes": ["ego_car", CAM], "refine_intr": [CAM], "refine_ts": [CAM]}
DELTA_SCALE = {"dquat": 1e-3, "dtrans": 1e-2, "dintr": 0.5, "dts": 1e-2}
FIELD_KW = dict(static_encoding_cfg={"n_levels": 4, "base_res": 8, "max_res": 32,
                                     "log2_hashmap_size": 10},
                dynamic_permuto_cfg={"n_levels": 3, "base_res": 4, "max_res": 16,
                                     "log2_hashmap_size": 10},
                geo_feat_dim=8, decoder_hidden=16, radiance_hidden=16)
LOSS_CFGS = {"rgb": {"fn_type": "huber", "fn_param": {"delta": 0.1}, "w": 10.0},
             "occupancy_mask": {"w": 0.1}, "flow": {"w": 0.01},
             "dynamic_sparsity": {"w": 0.01}}
TRAINING_CFGS = {"cr": {"lr": 0.01, "eps": 1.0e-15, "betas": (0.9, 0.99)},
                 "sky": {"lr": 0.003}, "Pose": {"lr": 0.001}}
LOSSES = ("loss_total", "loss_rgb", "loss_mask", "loss_flow", "loss_dynamic_sparsity")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6, name=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


def _grad_close(got, want, name=""):
    w = np.asarray(want)
    g = np.asarray(got.detach())
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-30),
                               err_msg=name)


# ---------------------------------------------------------------------------
# the maths
# ---------------------------------------------------------------------------

def _quats(n, seed):
    """Random unit quaternions with each component the largest for a
    quarter of them (every pivot of rot_to_quat), a few with w < 0."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    for k in range(4):
        q[k::4, k] = np.sign(q[k::4, k] + 0.1) * (np.abs(q[k::4]).max(-1) + 0.5)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def test_quaternion_maths_matches_jax():
    q0, q1 = _quats(32, 0), _quats(32, 1)
    q1[:3] = q0[:3]                       # parallel: slerp's lerp
    q1[3] = -q0[3]                        # antipodal: the shorter way round
    w = np.random.default_rng(2).random(32).astype(np.float32)
    w[:2] = [0.0, 1.0]
    R = jtf.quat_to_rot(jnp.asarray(q0))
    _close(tf.quat_to_rot(_t(q0)), R)
    _close(tf.quat_normalize(_t(q0 * 3.0)), jtf.quat_normalize(jnp.asarray(q0 * 3.0)))
    _close(tf.rot_to_quat(_t(np.asarray(R))), jtf.rot_to_quat(R), atol=2e-6)
    _close(tf.quat_mul(_t(q0), _t(q1)), jtf.quat_mul(jnp.asarray(q0), jnp.asarray(q1)))
    _close(tf.lerp(_t(q0), _t(q1), _t(w[:, None])),
           jtf.lerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(w[:, None])))
    want = jtf.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), jnp.asarray(w))
    _close(tf.quat_slerp(_t(q0), _t(q1), _t(w)), want, atol=2e-6)
    # the weight's gradient through both branches
    cot = np.random.default_rng(3).normal(size=(32, 4)).astype(np.float32)
    jg = jax.grad(lambda t: jnp.sum(jtf.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), t)
                                    * cot))(jnp.asarray(w))
    wt = _t(w).requires_grad_(True)
    g, = torch.autograd.grad((tf.quat_slerp(_t(q0), _t(q1), wt) * _t(cot)).sum(), wt)
    _grad_close(g, jg, "d slerp / d t")


def _rigid(n, seed):
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T[:, :3, :3] = np.asarray(jtf.quat_to_rot(jnp.asarray(_quats(n, seed))))
    T[:, :3, 3] = rng.normal(size=(n, 3)) * 5.0
    return T


@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.3], ids=["zero", "small", "large"])
def test_apply_delta_and_intr_delta_match_jax(scale):
    """Values and the gradients into the deltas (and the transform), at zero
    deltas (the smoothed norm's finite gradient) and non-zero ones."""
    rng = np.random.default_rng(int(scale * 1e4))
    T = _rigid(16, 4)
    dq = (rng.normal(size=(16, 3)) * scale).astype(np.float32)
    dt = (rng.normal(size=(16, 3)) * scale).astype(np.float32)
    intr = np.tile(np.array([[100, 0.5, 60], [0, 98, 40], [0, 0, 1]], np.float32), (16, 1, 1))
    di = (rng.normal(size=(16, 4)) * scale * 10).astype(np.float32)
    cot = rng.normal(size=(16, 4, 4)).astype(np.float32)
    cot_i = rng.normal(size=(16, 3, 3)).astype(np.float32)

    def jloss(T_, dq_, dt_, di_):
        out = JaxLP.apply_delta(T_, dq_, dt_)
        k = JaxLP.apply_intr_delta(jnp.asarray(intr), di_)
        return jnp.sum(out * cot) + jnp.sum(k * cot_i), (out, k)

    (_, (jout, jk)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (T, dq, dt, di)))
    ins = [_t(a).requires_grad_(True) for a in (T, dq, dt, di)]
    out = LearnableParams.apply_delta(*ins[:3])
    k = LearnableParams.apply_intr_delta(_t(intr), ins[3])
    _close(out, jout)
    _close(k, jk)
    grads = torch.autograd.grad((out * _t(cot)).sum() + (k * _t(cot_i)).sum(), ins)
    for name, g, w in zip(("transform", "dquat", "dtrans", "dintr"), grads, jg):
        assert torch.isfinite(g).all(), name
        _grad_close(g, w, name)


def test_learnable_params_builds_jax_s_tree():
    """The asset on the demo scene: the same leaves, shapes and zeros as
    JAX's ``init`` (refine_nodes by default the observers; refine_intr /
    refine_ts True for every camera / observer; the holistic offset), and
    the bridge copies JAX's tree in leaf by leaf."""
    scenario = demo_scenario()
    for mp in (POSE_MP, {}, {"refine_intr": True, "refine_ts": True,
                             "ts_holistic_offset": True, "enable_after": 7}):
        ja = JaxLP(dict(mp))
        ja.populate(JaxScene.load_from_scenario(scenario))
        a = LearnableParams(dict(mp))
        a.populate(Scene.load_from_scenario(scenario))
        tree = jax.tree.map(np.asarray, ja.init(jax.random.PRNGKey(0)))
        want = named_jax_leaves({"Pose": tree}, {"Pose": "Pose"})
        got = dict(nn.ModuleDict({"Pose": a.field}).named_parameters())
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(not v.any() for v in got.values())
        assert (a.refine_nodes, a.intr_nodes, a.ts_nodes, a.enable_after, a.ts_holistic) == \
            (ja.refine_nodes, ja.intr_nodes, ja.ts_nodes, ja.enable_after, ja.ts_holistic)
        a.field.reset_parameters(torch.Generator().manual_seed(0))
        load_jax_params(a.field, jax.tree.map(lambda x: x + 1.0, tree))
        assert all(torch.equal(v, torch.ones_like(v)) for v in a.field.parameters())


# ---------------------------------------------------------------------------
# the scene graph with deltas
# ---------------------------------------------------------------------------

def _trees(holistic=False, seed=0):
    """JAX's tree and the port's module of LearnableParams on the demo scene,
    both holding the same seeded non-zero deltas."""
    scenario = demo_scenario()
    jscene, scene = JaxScene.load_from_scenario(scenario), Scene.load_from_scenario(scenario)
    mp = {**POSE_MP, "ts_holistic_offset": holistic}
    ja, a = JaxLP(dict(mp)), LearnableParams(dict(mp))
    ja.populate(jscene)
    a.populate(scene)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, ja.init(jax.random.PRNGKey(0)))
    tree = {nid: {k: (rng.normal(size=v.shape) * DELTA_SCALE[k]).astype(np.float32)
                  for k, v in pd.items()} for nid, pd in tree.items()}
    load_jax_params(a.field, tree)
    return jscene, scene, ja, a, tree


@pytest.mark.parametrize("mode", ["slice_at", "interp_at", "interp_at_holistic"])
def test_scene_with_deltas_matches_jax(mode):
    """Every node's world transform and the camera's intrinsics at 40 rays'
    frames, and their gradients into every delta, against JAX; in timestamp
    mode the camera's timestamps (``sensor_ts`` with ``dts``) too."""
    jscene, scene, _, a, tree = _trees(holistic=mode.endswith("holistic"), seed=5)
    rng = np.random.default_rng(6)
    fidx = rng.integers(0, 8, 40).astype(np.int32)
    fidx[:8] = np.arange(8)
    ids = [n.id for n in scene.nodes_topo]
    assert ids == [n.id for n in jscene.nodes_topo]
    cots = {nid: rng.normal(size=(40, 4, 4)).astype(np.float32) for nid in ids}
    cot_i = rng.normal(size=(40, 3, 3)).astype(np.float32)

    def freeze(sc, deltas, f):
        if mode == "slice_at":
            return sc.slice_at(f, pose_deltas=deltas), None
        ts = sc.sensor_ts(CAM, f, dts=deltas[CAM]["dts"])
        return sc.interp_at(ts, pose_deltas=deltas), ts

    def jloss(deltas):
        fr, ts = freeze(jscene, deltas, jnp.asarray(fidx))
        out = {nid: fr.world_transform(nid) for nid in ids}
        loss = sum(jnp.sum(out[nid] * cots[nid]) for nid in ids) \
            + jnp.sum(fr.data(CAM)["intr"] * cot_i)
        return loss, (out, fr.data(CAM)["intr"], ts)

    (_, (jout, jintr, jts)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    fr, ts = freeze(scene, a.field, _t(fidx).long())
    loss = sum((fr.world_transform(nid) * _t(cots[nid])).sum() for nid in ids) \
        + (fr.data(CAM)["intr"] * _t(cot_i)).sum()
    for nid in ids:
        _close(fr.world_transform(nid), jout[nid], atol=2e-5, name=nid)
    _close(fr.data(CAM)["intr"], jintr, name="intr")
    if ts is not None:
        _close(ts, jts, name="ts")
    named = dict(a.field.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    want = named_jax_leaves({"p": jg}, {"p": "p"})
    for (k, p), g in zip(named.items(), grads):
        # frame slicing reads no timestamp: dts gets no gradient in either
        assert (np.abs(want[f"p.{k}"]).max() > 0) == (mode != "slice_at" or k != f"{CAM}.dts"), k
        _grad_close(torch.zeros_like(p) if g is None else g, want[f"p.{k}"], k)


def test_interp_at_keyframes_is_slice_at_and_valid_is_both_keyframes():
    """Without deltas, interpolation at a node's own keyframe times gives the
    frame's pose; halfway, the slerp and lerp of JAX."""
    scenario = demo_scenario()
    jscene, scene = JaxScene.load_from_scenario(scenario), Scene.load_from_scenario(scenario)
    ts = np.array([0.0, 0.1, 0.35, 0.7, 0.75, -0.2, 2.0], np.float32)
    jf, f = jscene.interp_at(jnp.asarray(ts)), scene.interp_at(_t(ts))
    for n in scene.nodes_topo:
        _close(f.world_transform(n.id), jf.world_transform(n.id), atol=2e-5, name=n.id)
        assert torch.equal(f.valid(n.id), _t(np.asarray(jf.valid(n.id))))
    sl = scene.slice_at(_t(np.arange(2)).long())
    for n in scene.nodes_topo:
        _close(f.world_transform(n.id)[:2], sl.world_transform(n.id).numpy(), atol=2e-5)


# ---------------------------------------------------------------------------
# K3's gradient to the positions
# ---------------------------------------------------------------------------

K3_LEVELS = [(8, 2, "dense"), (16, 2, "dense"), (32, 2, "hash"), (64, 2, "hash")]


def _edge_points(n, seed):
    """Points inside the box, on its faces (u = 0 and u = 1), on cell faces
    of every level (k / 8), and outside it on either side."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)).astype(np.float32)
    x[0:4, 0], x[4:8, 1], x[8:12, 2] = 0.0, 1.0, 0.0
    x[12:16, 1], x[16:20] = 1.0, 0.0
    x[20:28, 0] = np.arange(1, 9, dtype=np.float32) / 8
    x[28:36, 2] = np.arange(1, 9, dtype=np.float32) / 16
    x[36:40, 1] = [-0.2, -1e-3, 1.001, 1.5]
    return x


def test_plain_k3_gradient_to_the_positions_matches_jax():
    """lotd_grid_bwd_x (the plain version on the CPU) and autograd through
    the encoding against JAX's autodiff of ``_level_features`` on dense and
    hash levels, edge points included (half the gradient on the box's faces,
    none outside)."""
    jenc = JaxLoTD(K3_LEVELS, 3, log2_hashmap_size=10)
    enc = LoTDEncoding(K3_LEVELS, 3, log2_hashmap_size=10)
    assert [s.typ for s in enc.specs] == ["dense", "dense", "hash", "hash"]
    table = np.random.default_rng(7).normal(size=enc.total_params).astype(np.float32)
    with torch.no_grad():
        enc.table.copy_(_t(table))
    x = _edge_points(200, 8)
    cot = np.random.default_rng(9).normal(size=(200, enc.out_dim)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda xx: jnp.sum(jenc({"table": jnp.asarray(table)}, xx) * cot)))(
        jnp.asarray(x))
    d_out = _t(np.ascontiguousarray(cot.T))
    got = lotd_grid_bwd_x(enc.table, _t(x), enc._grid_meta, d_out)
    assert torch.equal(got, lotd_grid_bwd_x_plain(enc.table, _t(x), enc._grid_meta, d_out))
    _grad_close(got, jg, "d pos01")
    jg = np.asarray(jg)
    assert np.all(jg[36:40, 1] == 0) and np.abs(jg[36:40, 0]).max() > 0
    xt = _t(x).requires_grad_(True)
    g, = torch.autograd.grad((enc(xt) * _t(cot)).sum(), xt)
    _grad_close(g, jg, "d x through the encoding")
    # on a face the gradient is half the inside's: the face point nudged in
    xin = x[:20].copy()
    xin[xin == 0.0], xin[xin == 1.0] = 1e-7, 1 - 6e-8
    inner = np.asarray(jax.jit(jax.grad(lambda xx: jnp.sum(
        jenc({"table": jnp.asarray(table)}, xx) * cot[:20])))(jnp.asarray(xin)))
    face = (x[:20] == 0.0) | (x[:20] == 1.0)
    np.testing.assert_allclose(jg[:20][face], 0.5 * inner[face], rtol=2e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# EmerNeRF's step with a Pose asset
# ---------------------------------------------------------------------------

def _field_params(field, seed):
    """JAX's init with the tables moved to trained magnitudes and random
    decoder biases (tests/test_torch_emernerf.py's)."""
    p = jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for enc in ("static_enc", "dyn_enc"):
        p[enc]["table"] = rng.normal(0.0, 0.5, p[enc]["table"].shape).astype(np.float32)
    for dec in ("static_dec", "dyn_dec", "flow_dec"):
        for layer in p[dec]["layers"]:
            layer["b"] = rng.normal(0.0, 0.5, layer["b"].shape).astype(np.float32)
    return p


def make_trainers(use_ts_interp, enable_after=0, zero_deltas=False, seed=0):
    """Both packages' renderer and trainer on the demo scene, with the same
    field, sky and pose parameters -> (JAX trainer, JAX params, trainer,
    params)."""
    jscene, scene, _, pose, tree = _trees(seed=seed)
    if zero_deltas:
        tree = jax.tree.map(np.zeros_like, tree)
    box = LoTDNeuSStreet.aabb_from_cameras(scene, {"extend_size": 8.0})
    jf = JaxEmerNeRF(JaxSpace(*box), **FIELD_KW)
    f = EmerNeRFField(AABBSpace(*box), **FIELD_KW)
    jsky = JaxSky(hidden=8)
    jparams = {"cr": _field_params(jf, seed), "Pose": tree,
               "sky": jax.tree.map(np.asarray, jsky.init(jax.random.PRNGKey(9)))}
    params = nn.ModuleDict({"cr": f, "sky": SimpleSky(hidden=8), "Pose": pose.field})
    load_jax_params(params, jparams)
    jr = JaxRenderer({"cr": jf, "sky": jsky}, query_cfg={"num_coarse": NC})
    r = SingleVolumeRenderer(query_cfg={"num_coarse": NC},
                             param_keys={"cr": "cr", "sky": "sky"})
    kw = dict(training_cfgs=TRAINING_CFGS, uniform_sample_n=N_FLOW, pose_model_id="Pose",
              pose_enable_after=enable_after, use_ts_interp=use_ts_interp)
    jt = JaxTrainer(jr, loss_cfgs=LOSS_CFGS, scene=jscene, **kw)
    t = Trainer(r, loss_cfgs=dict(LOSS_CFGS), scene=scene, **kw)
    return jt, jparams, t, params


def _batch(seed):
    """48 pixels of random frames (80 x 120 frames), random colours and masks."""
    rng = np.random.default_rng(seed)
    return {"rays_fidx": rng.integers(0, 8, N_RAYS).astype(np.int32),
            "rays_xy": (rng.random((N_RAYS, 2)) * [120.0, 80.0]).astype(np.float32),
            "image_rgb": rng.random((N_RAYS, 3)).astype(np.float32),
            "image_occupancy_mask": (rng.random(N_RAYS) < 0.7).astype(np.float32)}


def _noise(key):
    """The port's draws of one JAX step from its key (tests/test_torch_emernerf.py's)."""
    k_render, k_uniform, _ = jax.random.split(key, 3)
    kcr, _ = jax.random.split(k_render)
    kk = jax.random.fold_in(k_uniform, 101)
    return {"coarse": _t(jax.random.uniform(kcr, (N_RAYS, NC))),
            "flow_points": _t(jax.random.uniform(kk, (N_FLOW, 3))),
            "flow_times": _t(jax.random.uniform(jax.random.fold_in(kk, 1), (N_FLOW,)))}


@pytest.mark.parametrize("use_ts_interp", [False, True], ids=["slice_at", "timestamps"])
def test_first_step_with_pose_deltas_matches_jax(use_ts_interp):
    """One step's loss terms (rtol 1e-4) and every gradient leaf (1e-4 of
    its largest entry), the pose, intrinsics and timestamp leaves included:
    each of them reached."""
    jt, jparams, t, params = make_trainers(use_ts_interp)
    b = _batch(13)
    key = jax.random.PRNGKey(14)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jp = jax.tree.map(jnp.asarray, jparams)
    (_, jx), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.compute_losses(p, jb, 0, key, "pixel", None, CAM), has_aux=True))(jp)
    total, ex = t.compute_losses(params, {k: _t(v) for k, v in b.items()}, 0, _noise(key),
                                 None, "pixel", CAM)
    assert set(ex["losses"]) == set(jx["losses"]) == set(LOSSES[1:])
    for k, v in jx["losses"].items():
        _close(ex["losses"][k], v, rtol=1e-4, atol=0, name=k)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    want = named_jax_leaves(jg, {"cr": "cr", "sky": "sky", "Pose": "Pose"})
    assert set(want) == set(named)
    for (k, p), g in zip(named.items(), grads):
        w = np.asarray(want[k])
        g = torch.zeros_like(p) if g is None else g
        _grad_close(g, w, k)
        # frame slicing reads no timestamp: dts gets no gradient in either
        assert (np.abs(w).max() > 0) == (use_ts_interp or k != f"Pose.{CAM}.dts"), k


def _adam_count(opt_state, role):
    chain = opt_state.inner_states[role].inner_state
    return int(next(s for s in chain if isinstance(s, optax.ScaleByAdamState)).count)


@pytest.fixture(scope="module")
def runs():
    """Three steps of both packages' ``train_step`` in timestamp mode with
    ``enable_after`` 1 from zero deltas (a fresh asset: every timestamp on a
    keyframe, where the weight's clip passes half its gradient), on the same
    batches and draws."""
    jt, jparams, t, params = make_trainers(True, enable_after=1, zero_deltas=True, seed=1)
    state = t.init_state(params)
    jstate = jt.init_state(None, params=jax.tree.map(jnp.asarray, jparams))
    jstep = jax.jit(lambda st, bb, kk: type(jt).train_step.__wrapped__(jt, st, bb, kk, "pixel",
                                                                       CAM, True))
    out = []
    key = jax.random.PRNGKey(15)
    for i in range(3):
        key, k = jax.random.split(key)
        b = _batch(20 + i)
        jb = {name: jnp.asarray(v) for name, v in b.items()}
        state, m = t.train_step(state, {name: _t(v) for name, v in b.items()}, _noise(k),
                                "pixel", CAM)
        jstate, jm = jstep(jstate, jb, k)
        out.append(({name: float(m[name]) for name in LOSSES + ("step_skipped",)},
                    {name: float(jm[name]) for name in LOSSES + ("step_skipped",)},
                    {k2: v.detach().clone() for k2, v in params.named_parameters()},
                    jax.device_get(jstate.params),
                    {mid: int(opt.count) for mid, opt in state.opt.items()},
                    {mid: _adam_count(jstate.opt_state, mid) for mid in ("cr", "sky", "Pose")},
                    (state.it, int(jstate.it))))
    return out, {mid: float(opt.lr()) for mid, opt in state.opt.items()}


@pytest.mark.parametrize("step", [0, 1, 2])
def test_each_step_follows_jax_with_the_gate(runs, step):
    """Losses (rtol 1e-4), ``it``, every Adam count, and every parameter
    within the lr bounds; the deltas exactly zero after the step before the
    gate and non-zero after the first one past it."""
    (got, want, params, jparams, counts, jcounts, its), lrs = runs[0][step], runs[1]
    assert got["step_skipped"] == want["step_skipped"] == 0
    for k in LOSSES:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {step} {k}")
    assert its == (step + 1, step + 1)
    assert counts == jcounts == {"cr": step + 1, "sky": step + 1, "Pose": step + 1}
    want_p = named_jax_leaves(jparams, {"cr": "cr", "sky": "sky", "Pose": "Pose"})
    assert set(want_p) == set(params)
    for k, p in params.items():
        diff = np.abs(p.numpy() - np.asarray(want_p[k]))
        lr = lrs[k.split(".")[0]]
        assert np.mean(diff > lr) <= 5e-3 and diff.max() <= 6 * lr, (k, float(diff.max()), lr)
        if k.startswith("Pose."):
            assert (not p.any()) == (step == 0), (k, step)
            assert (not np.asarray(want_p[k]).any()) == (step == 0), k
