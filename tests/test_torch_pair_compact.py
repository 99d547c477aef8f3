"""Port parity for the pair-budget compaction of a shared model's group (K11,
``neuralsim_torch.ops.pair_compact``) and for the compose renderer's
pair-budget path, against the JAX package on the CPU.

K11: the port's plain version against the JAX package's own lines
(neuralsim_tpu/renderers/buffer_compose.py:185-193 and 296-303, copied below
and run on small ``jnp`` arrays): the selected pairs, their hit flags and the
slot lanes of the training path, integer for integer, for K in {2, 5, 8}, a
budget above and below the number of hits (misses fill the budget), a budget
of half the rays at an odd N, and rays that cross more boxes than a ray has
slot lanes (their later hits are dropped, as in the JAX package).

The compose path: ``BufferComposeRenderer.ray_query`` on a crowd of 6
vehicles (``group_budget_frac: auto`` takes the pair-budget path from 5) with
per-instance occupancy grids, against the JAX renderer built from the same
dict: ``with_per_obj=True`` (the render: rows scattered back to each
instance) on one frame's rays, and ``with_per_obj=False`` (training: the group
folded into one source of ``max_hits_per_ray`` slot lanes a ray) on rays of
mixed frames, so each row takes its own object pose. Small size: the
compose render test's widths, 6 vehicles, 32x48 frames, the vehicles' 16^3
grids converged on the model's own SDF and the street's 16^3 grid on the
drive's ground, both handed to JAX as numpy. The sample placements are shared
as in test_torch_multi_train.py: the port records every grid proposal and
upsample stage's depths and the JAX query, traced anew and jitted, takes them
(the placements themselves are held in test_torch_occ_batched.py and
test_torch_upsample.py).
The limits are test_torch_compose_render.py's: the vehicles' shares within
2e-4 per ray (relative to 1 + |value|), the street's, the distant field's and
the whole frame's by the share of rays beyond 1e-4 and 5e-3 and the mean; the
training path's group, which has no share of its own there, is held lane by
lane in the merged buffer and, under a loss, in test_torch_crowd_train.py.
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuralsim_tpu.fields.neus as jax_neus
from neuralsim_tpu.accel.occ_grid import OccGridState as JaxOcc
from neuralsim_tpu.renderers.buffer_compose import BufferComposeRenderer as JaxCompose
from neuralsim_tpu.scene import AssetBank as JaxBank
from neuralsim_tpu.scene import Scene as JaxScene
from neuralsim_tpu.scene.observers import camera_get_selected_rays as jax_selected_rays
import neuralsim_torch.fields.neus as port_neus
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.configs import WAYMO_DEMO_CROWD
from neuralsim_torch.dataio.waymo_demo import demo_scenario, ground_sdf_tensor
from neuralsim_torch.ops.pair_compact import pair_budget, pair_compact, pair_compact_plain
from neuralsim_torch.scene.observers import camera_get_selected_rays
from neuralsim_torch.tools.build import build_compose_renderer, converge_occ

torch.set_num_threads(1)

RAY_TOL = 2e-4


def _jax_pair(hit, Bg, M):
    """The JAX package's lines: the selection (buffer_compose.py:185-193) and
    the slot assignment (:296-303)."""
    K, N = hit.shape
    rank = jnp.cumsum(hit, axis=1) - 1
    keyv = jnp.where(hit, rank * K + jnp.arange(K, dtype=jnp.int32)[:, None],
                     jnp.int32(K * N))
    order = jnp.argsort(keyv.reshape(-1))[:Bg]
    hit_c = jnp.take(keyv.reshape(-1), order) < K * N
    r_idx = order % N
    r_for_slot = jnp.where(hit_c, r_idx, N)
    perm = jnp.argsort(r_for_slot)
    r_s = r_for_slot[perm]
    slot = jnp.arange(Bg) - jnp.searchsorted(r_s, r_s, side="left")
    flat_idx = jnp.where((r_s < N) & (slot < M), r_s * M + slot, N * M)
    # the slot scatter of the rows' own numbers, mode="drop" (the sink drops)
    lanes = jnp.full((N * M,), -1).at[flat_idx].set(jnp.arange(Bg)[perm], mode="drop")
    return order, hit_c, lanes


def _hits(K, N, p, seed):
    rng = np.random.default_rng(seed)
    rate = np.linspace(p / 2, min(p * 1.5, 1.0), K)[:, None]
    return rng.random((K, N)) < rate


def _check_against_jax(hit, Bg, M):
    order, hit_c, lanes = jax.tree.map(np.asarray, _jax_pair(jnp.asarray(hit), Bg, M))
    got_o, got_h, slot_idx = pair_compact(torch.from_numpy(hit), Bg, M)
    np.testing.assert_array_equal(got_o.numpy(), order)
    np.testing.assert_array_equal(got_h.numpy(), hit_c)
    N = hit.shape[1]
    got_lanes = torch.full((N * M + 1,), -1, dtype=torch.int64).index_copy(
        0, slot_idx, torch.arange(Bg))[:N * M]
    np.testing.assert_array_equal(got_lanes.numpy(), lanes)
    # without the slots the selection is the same
    o2, h2, s2 = pair_compact_plain(torch.from_numpy(hit), Bg, None)
    assert s2 is None and torch.equal(o2, got_o) and torch.equal(h2, got_h)
    return int(hit.sum())


@pytest.mark.parametrize("gf", [0.5, 1.0])
@pytest.mark.parametrize("dense", [False, True], ids=["T<Bg", "T>Bg"])
@pytest.mark.parametrize("K", [2, 5, 8])
def test_k11_selection_and_slots_match_jax(K, dense, gf):
    N = 97                                        # odd: round(48.5) is 48, Python's round
    hit = _hits(K, N, 0.8 if dense else 0.06, K + 10 * dense)
    Bg = pair_budget(K, N, gf)
    assert Bg == max(min(K * N, int(round(N * gf))), 1)
    T = _check_against_jax(hit, Bg, 4)
    assert (T > Bg) == dense


def test_k11_drops_the_hits_beyond_the_slot_lanes():
    """Rays through all 8 boxes: the first 4 selected hits of a ray take its
    lanes, the rest go to the sink."""
    hit = _hits(8, 64, 0.2, 3)
    hit[:, ::5] = True
    _check_against_jax(hit, 64, 4)
    _check_against_jax(hit, 128, 2)
    order, hit_c, slot_idx = pair_compact_plain(torch.from_numpy(hit), 128, 2)
    r = order % 64
    kept = slot_idx < 64 * 2
    assert int(torch.bincount(r[kept], minlength=64).max()) == 2
    assert bool((slot_idx[~hit_c] == 64 * 2).all())


def test_k11_budget_edges():
    """No hit at all (the budget is misses in flat order), every pair a hit,
    a budget of one row and one of every pair."""
    for hit in (np.zeros((3, 11), bool), np.ones((3, 11), bool)):
        for Bg in (1, 11, 33):
            _check_against_jax(hit, Bg, 4)
    order, hit_c, _ = pair_compact_plain(torch.zeros((3, 11), dtype=torch.bool), 5, 4)
    assert order.tolist() == [0, 1, 2, 3, 4] and not bool(hit_c.any())


# ---------------------------------------------------------------------------
# The compose renderer's pair-budget path
# ---------------------------------------------------------------------------

CROWD = copy.deepcopy(WAYMO_DEMO_CROWD)
CROWD["dataset_cfg"]["params"] = {"n_frames": 3, "H": 32, "W": 48, "n_vehicles": 6, "seed": 0}
_B = CROWD["assetbank_cfg"]
_B["Vehicle"]["model_params"].update(
    z_dim=4, geo_feat_dim=7, radiance_hidden=16,
    encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2, "cp_max_res": 32},
    query_cfg={"num_coarse": 8, "num_fine": [4], "upsample_inv_s_factors": [1.0]})
_B["Vehicle"]["model_params"]["accel_cfg"]["resolution"] = 16
_B["Street"]["model_params"].update(
    geo_feat_dim=7, radiance_hidden=16,
    encoding_cfg={"type": "tpu_mixed", "n_levels": 3, "base_res": 16, "max_res": 64,
                  "n_feats": 2, "n_hash_levels": 0, "cp_max_res": 64},
    query_cfg={"num_coarse": 8, "num_fine": [4, 4], "upsample_inv_s": 64.0,
               "upsample_inv_s_factors": [1.0, 4.0]})
_B["Street"]["model_params"]["accel_cfg"].update(resolution=16, samples_per_voxel=1)
_B["Distant"]["model_params"].update(geo_feat_dim=4, query_cfg={"num_samples": 8})
_B["Sky"]["model_params"] = {"hidden": 8}
CAM, VEH = "camera_FRONT", "Vehicle#demo_drive"


@pytest.fixture(scope="module")
def crowd():
    scene, bank, renderer, params = build_compose_renderer(CROWD, device="cpu")
    jscene = JaxScene.load_from_scenario(demo_scenario(**CROWD["dataset_cfg"]["params"]))
    jbank = JaxBank.create(_B, [jscene])
    r = CROWD["renderer"]
    jr = JaxCompose.from_asset_bank(jscene, jbank, cr_class=r["cr_class"],
                                    distant_class=r["distant_class"], sky_class=r["sky_class"],
                                    hit_budget_frac=0.5, group_budget_frac=r["group_budget_frac"],
                                    max_hits_per_ray=r["max_hits_per_ray"])
    jp = jax.tree.map(np.asarray, jbank.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for tree in jp.values():            # move the tables off their init, so the fields vary
        if "encoding" in tree:
            tbl = tree["encoding"]["table"]
            tree["encoding"]["table"] = (tbl + rng.normal(0, 0.1, tbl.shape)).astype(np.float32)
    jp[VEH]["latents"] = rng.normal(0, 0.3, jp[VEH]["latents"].shape).astype(np.float32)
    load_jax_params(params, jp)
    sa, va = renderer.accels["cr"], renderer.accels[VEH]
    occ = {"cr": converge_occ(sa, sa.init_state(), ground_sdf_tensor, n=30),
           VEH: converge_occ(va, va.init_state(),
                             lambda x, b: params[VEH].query_sdf(x, bidx=b), n=30)}
    jocc = {k: JaxOcc(jnp.asarray(v.val.numpy()), jnp.asarray(v.mask.numpy()))
            for k, v in occ.items()}
    return dict(scene=scene, renderer=renderer, params=params, occ=occ, jscene=jscene, jr=jr,
                jp=jax.tree.map(jnp.asarray, jp), jocc=jocc)


@contextlib.contextmanager
def _records(renderer, placements):
    """Record the port's sample depths (grid proposals, upsample stages) in call order."""
    upsample = port_neus.upsample_weights_pdf
    accels = renderer.accels
    names = {"cr": "ray_proposal", VEH: "ray_proposal_batched"}

    def wrap(key):
        fn = getattr(type(accels[key]), names[key])

        def proposal(*a, **kw):
            t, m = fn(accels[key], *a, **kw)
            placements.append(t.numpy().copy())
            return t, m
        return proposal

    def stage(*a, **kw):
        w, t_new = upsample(*a, **kw)
        placements.append(t_new.numpy().copy())
        return w, t_new

    for key in names:
        setattr(accels[key], names[key], wrap(key))
    port_neus.upsample_weights_pdf = stage
    try:
        yield
    finally:
        for key in names:
            delattr(accels[key], names[key])
        port_neus.upsample_weights_pdf = upsample


@contextlib.contextmanager
def _takes(jr, placements):
    """Hand ``placements`` to the JAX query, in the same order."""
    queue, pdf = list(placements), jax_neus.sample_pdf

    def take(shape):
        t = queue.pop(0)
        assert t.shape == tuple(shape), (t.shape, shape)
        return jnp.asarray(t)

    def proposal(st, rays_o, rays_d, near, far, n, *a, **kw):
        return take((rays_o.shape[0], n)), jnp.ones((rays_o.shape[0], n), bool)

    jr.accels["cr"].ray_proposal = proposal
    jr.accels[VEH].ray_proposal_batched = proposal
    jax_neus.sample_pdf = lambda bins, w, n, **kw: take(bins.shape[:-1] + (n,))
    try:
        yield
    finally:
        del jr.accels["cr"].ray_proposal, jr.accels[VEH].ray_proposal_batched
        jax_neus.sample_pdf = pdf
    assert not queue


def _ray_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    e = np.abs(got - want) / (1.0 + np.abs(want))
    return e.reshape(e.shape[0], -1).max(-1)


@pytest.fixture(scope="module", params=[True, False], ids=["render", "training"])
def queried(crowd, request):
    """One query of both renderers on the same rays, grids and placements:
    the render (one frame, per-instance scatter) or training (mixed frames,
    the group folded into slot lanes)."""
    with_per_obj = request.param
    rng = np.random.default_rng(5)
    n = 384
    fidx = np.zeros(n, np.int32) if with_per_obj else rng.integers(0, 3, n).astype(np.int32)
    xy = np.stack([rng.integers(0, 48, n) + 0.5, rng.integers(8, 24, n) + 0.5], -1) \
        .astype(np.float32)
    frozen = crowd["scene"].slice_at(torch.from_numpy(fidx).long())
    o, d = camera_get_selected_rays(frozen, CAM, torch.from_numpy(xy))
    placements = []
    with torch.no_grad(), _records(crowd["renderer"], placements):
        got = crowd["renderer"].ray_query(crowd["params"], frozen, o.contiguous(), d.contiguous(),
                                          occ_states=crowd["occ"], return_buffer=True,
                                          with_per_obj=with_per_obj)
    jo, jd = jax_selected_rays(crowd["jscene"].slice_at(jnp.asarray(fidx)), CAM, jnp.asarray(xy))
    np.testing.assert_allclose(np.asarray(jo), o.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jd), d.numpy(), atol=1e-6)
    names = []

    def query(p, rays_o, rays_d):
        out = crowd["jr"].ray_query(p, crowd["jscene"].slice_at(jnp.asarray(fidx)), rays_o,
                                    rays_d, occ_states=crowd["jocc"],
                                    query_overrides={"perturb": False}, return_buffer=True,
                                    with_per_obj=with_per_obj)
        names.extend(out.pop("src_names"))          # at trace time
        return {k: v for k, v in out.items() if k not in ("per_src", "details_cr")}

    with _takes(crowd["jr"], placements):
        want = jax.jit(query)(crowd["jp"], jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    want = {**jax.tree.map(np.asarray, want), "src_names": names}
    return with_per_obj, got, want


def test_crowd_takes_the_pair_budget_path(crowd, queried):
    with_per_obj, got, want = queried
    r = crowd["renderer"]
    assert r._pair_rows(r.objects, 384) == 384 and r.max_hits_per_ray == 4
    names = [f"veh_{i}" for i in range(6)] if with_per_obj else [f"group:{VEH}"]
    assert got["src_names"] == want["src_names"] == names + ["street", "distant"]
    lanes = 6 * 12 if with_per_obj else 4 * 12
    assert got["merged_buffer"]["t"].shape == (384, lanes + 16 + 8)


def _assert_bounded(e, name):
    """test_torch_compose_render.py's limits on the street's, the distant
    field's and the whole frame's rays."""
    assert (e > 1e-4).mean() <= 0.20, name
    assert (e > 5e-3).mean() <= 0.03, name
    assert e.mean() <= (5e-3 if "depth" in name else 2e-3), name


def test_crowd_query_matches_jax_per_ray(queried):
    """The vehicles' shares (the render's per-instance scatter) within
    RAY_TOL on every ray (measured <= 6.1e-5); the street's, the distant
    field's and the frame's under test_torch_compose_render.py's limits (the
    jitted JAX query fuses the street's and the distant field's arithmetic:
    measured <= 2.6e-4 in the street's depth share, and 2.4e-3 in one ray's
    frame depth, whose distant lanes lie 7e5 deep)."""
    with_per_obj, got, want = queried
    for k in ("rgb_volume", "depth_volume", "mask_volume", "normals_volume"):
        _assert_bounded(_ray_err(got[k].numpy(), want[k]), k)
    for name in want["rendered_per_obj_in_scene"]:
        sub, wsub = got["rendered_per_obj_in_scene"][name], want["rendered_per_obj_in_scene"][name]
        for k in ("rgb_volume", "depth_volume", "mask_volume"):
            e = _ray_err(sub[k].numpy(), wsub[k])
            if name.startswith("veh_"):
                assert e.max() <= RAY_TOL, (name, k)
            else:
                _assert_bounded(e, f"{name}.{k}")
    if with_per_obj:            # a vehicle shows, so the rows went somewhere
        veh = sum(float(got["rendered_per_obj_in_scene"][f"veh_{i}"]["mask_volume"].sum())
                  for i in range(6))
        assert veh > 1.0


def test_crowd_buffer_lanes_match_jax(queried):
    """The merged buffer's valid lanes ray by ray (the JAX package's is sorted
    by depth, the port's order-free one is not): their number and their
    depths in order, so every row reached its ray, and on the training path
    its slot lane."""
    _, got, want = queried
    gb, wb = got["merged_buffer"], want["merged_buffer"]
    np.testing.assert_array_equal(gb["mask"].numpy().sum(-1), wb["mask"].sum(-1))
    depths = lambda b: np.sort(np.where(np.asarray(b["mask"]), np.asarray(b["t"]), np.inf), -1)
    g, w = depths(gb), depths(wb)
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), fin)
    np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=1e-5)
