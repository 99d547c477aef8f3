"""The occupancy refresh around the field query (``neuralsim_torch.accel.occ_grid``:
K7's voxel points, K7 with the occupied count, ``occupied_fraction``) against
``neuralsim_tpu.accel.occ_grid`` on the CPU, at a small size: grids of 8^3
and 16^3, one grid with 1 and 4 samples a voxel, 3 per-instance grids, 2
keyframe grids.

Every draw is ``jax.random.uniform(key, [L, R, R, R, 3])``, the draw JAX's
``update`` makes from ``key``, handed to the port as numpy; the field values
are an analytic SDF evaluated in numpy on the points each package computed.

Held exactly: the points of ``occ_voxel_points_plain`` and the points JAX's
``update`` hands its query (R a power of two, where a division by R and a
product with 1 / R agree); K7's count against its mask's, and the fraction
a state keeps against the plain mean of its mask, bit for bit, at its start,
after updates and from the bridge; the single-scene trainer's ``occ_frac`` against the plain mean at
every step; ``converge_occ`` against the refresh as it was written before
the count (its results may not move). Within a tolerance: the refreshed
values within 1e-6 of JAX's (the occupancy is a sigmoid, and torch's exp and
XLA's differ in their last bit; see test_torch_occ_grid.py), the mask equal
away from the threshold by that much, the fraction within 1 / V of JAX's
``occupied_fraction``. The wrappers refuse wrong shapes, dtypes and states
without their fraction off the CPU (on the meta device here) before anything is built.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.accel.occ_grid import OccGridEma as JaxGrid
from neuralsim_tpu.accel.occ_grid import OccGridEmaBatched as JaxBatched
from neuralsim_tpu.accel.occ_grid import OccGridEmaDynamic as JaxDynamic
from neuralsim_tpu.fields.spatial import AABBSpace as JaxSpace
from neuralsim_torch.accel import OccGridEma, OccGridEmaBatched, OccGridEmaDynamic, OccGridState
from neuralsim_torch.accel.occ_grid import (occ_ema_update, occ_ema_update_plain,
                                            occ_voxel_points, occ_voxel_points_plain,
                                            occupied_fraction_plain)
from neuralsim_torch.bridge import grid_state_from_numpy, occ_state_from_numpy
from neuralsim_torch.dataio.synthetic import SyntheticObjectDataset, sdf_scene_tensor
from neuralsim_torch.fields.spatial import AABBSpace
from neuralsim_torch.tools.build import build_renderer, build_trainer, converge_occ
from neuralsim_torch.tools.train import to_device_batch
from test_torch_bench_model import N_RAYS, SMALL

torch.set_num_threads(1)

VAL_ATOL = 1e-6
THRE = 0.3
CFG = dict(occ_inv_s=64.0, n_warmup_steps=8, ema_decay=0.5)
# (kind, leading entries L): samples a voxel, instances or keyframes
KINDS = [("single", 1), ("single", 4), ("batched", 3), ("dynamic", 2)]
KIND_IDS = ["single_s1", "single_s4", "batched_b3", "dynamic_k2"]
BOX = (np.array([-1.5, -0.5, -2.0], np.float32), np.array([2.5, 1.0, 2.0], np.float32))


def _sdf(kind, x, lead=None):
    """A sphere of radius 0.6 ("single"), of a radius per instance
    ("batched": ``lead`` the instance index) or moving along x with the time
    ("dynamic": ``lead`` the keyframe's time in [0, 1]), in float64, returned
    as float32."""
    x = np.asarray(x, np.float64)
    r, c = 0.6, np.zeros(3)
    if kind == "batched":
        r = np.array([0.4, 0.6, 0.8])[np.asarray(lead, np.int64)]
    elif kind == "dynamic":
        t = np.asarray(lead, np.float64)
        c = np.stack([t - 0.5, np.zeros_like(t), np.zeros_like(t)], -1)
    return (np.linalg.norm(x - c, axis=-1) - r).astype(np.float32)


def _pair(kind, L, R, **kw):
    """(JAX grid, port grid) over the same box."""
    cfg = {**CFG, **kw}
    js, ps = JaxSpace(*(jnp.asarray(b) for b in BOX)), AABBSpace(*(torch.from_numpy(b)
                                                                   for b in BOX))
    if kind == "single":
        return (JaxGrid(js, R, samples_per_voxel=L, **cfg),
                OccGridEma(ps, R, samples_per_voxel=L, **cfg))
    if kind == "batched":
        return JaxBatched(js, L, R, **cfg), OccGridEmaBatched(ps, L, R, **cfg)
    return (JaxDynamic(js, R, n_keyframes=L, **cfg),
            OccGridEmaDynamic(ps, R, n_keyframes=L, **cfg))


def _query_pair(kind, seen=None):
    """The same SDF as a JAX and a port query; ``seen`` keeps the points JAX
    hands its query."""
    def jq(x, *lead):
        if seen is not None:
            seen.append((np.asarray(x),) + tuple(np.asarray(b) for b in lead))
        return jnp.asarray(_sdf(kind, x, *(np.asarray(b) for b in lead)))

    def pq(x, *lead):
        return torch.from_numpy(_sdf(kind, x.numpy(), *(b.numpy() for b in lead)))
    return jq, pq


def _jitter(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape)))


def _assert_state(got, want):
    val = np.asarray(want.val)
    np.testing.assert_allclose(got.val.numpy(), val, rtol=0, atol=VAL_ATOL)
    differ = got.mask.numpy() != np.asarray(want.mask)
    assert not np.any(differ & (np.abs(val - THRE) > VAL_ATOL))


def _assert_counted(state):
    """The fraction the state keeps is its mask's plain mean, bit for bit."""
    assert state.frac.dtype == torch.float32
    assert torch.equal(state.frac, occupied_fraction_plain(state.mask))


@pytest.mark.parametrize("R", [8, 16])
@pytest.mark.parametrize("kind,L", KINDS, ids=KIND_IDS)
def test_voxel_points_are_the_points_jax_queries(kind, L, R):
    jg, pg = _pair(kind, L, R)
    key = jax.random.PRNGKey(5)
    seen = []
    jq, _ = _query_pair(kind, seen)
    jg.update(jg.init_state(), jq, key, 1000)
    u = _jitter(key, pg.jitter_shape)
    lead = {"single": None, "batched": "index", "dynamic": "time"}[kind]
    got = occ_voxel_points_plain(u, *pg.box("cpu"), lead)
    points = got if lead is None else got[0]
    assert points.shape == (L * R ** 3, 3) and points.dtype == torch.float32
    np.testing.assert_array_equal(points.numpy(), seen[0][0])
    if lead is not None:         # each point's instance index (int64), or its keyframe's time
        assert got[1].dtype == (torch.int64 if lead == "index" else torch.float32)
        np.testing.assert_array_equal(got[1].numpy(), seen[0][1].astype(got[1].numpy().dtype))
        assert seen[0][1].dtype == (np.int32 if lead == "index" else np.float32)
    # the wrapper takes the plain version on the CPU, and so does the grid
    again = occ_voxel_points(u, *pg.box("cpu"), lead)
    assert all(torch.equal(a, b) for a, b in zip(again, got)) if lead else torch.equal(again, got)
    assert torch.equal(pg._voxel_points(u), points)


@pytest.mark.parametrize("warm", [False, True], ids=["after_warm_up", "warm_up"])
@pytest.mark.parametrize("kind,L", KINDS, ids=KIND_IDS)
def test_refresh_matches_jax_and_keeps_its_count(kind, L, warm):
    R = 8
    jg, pg = _pair(kind, L, R)
    jq, pq = _query_pair(kind)
    js, ps = jg.init_state(), pg.init_state()
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        it = i if warm else 1000
        js = jg.update(js, jq, key, it)
        ps = pg.update(ps, pq, _jitter(key, pg.jitter_shape), it)
        _assert_state(ps, js)
        _assert_counted(ps)
        assert abs(float(pg.occupied_fraction(ps)) - float(jg.occupied_fraction(js))) \
            <= 1.0 / ps.mask.numel()
    if warm:                     # the floor keeps every voxel occupied: the count is V
        assert bool(ps.mask.all()) and float(ps.frac) == 1.0
    else:
        assert 0.0 < float(ps.frac) < 1.0


@pytest.mark.parametrize("occupied", [True, False])
@pytest.mark.parametrize("kind,L", KINDS, ids=KIND_IDS)
def test_start_and_bridge_states_keep_their_count(kind, L, occupied):
    jg, pg = _pair(kind, L, 8, init_occupied=occupied)
    st = pg.init_state()
    _assert_counted(st)
    assert float(st.frac) == (1.0 if occupied else 0.0)
    np.testing.assert_array_equal(st.val.numpy(), np.asarray(jg.init_state().val))
    rng = np.random.default_rng(3)
    val = rng.random(st.val.shape).astype(np.float32)
    load = occ_state_from_numpy if kind == "single" else grid_state_from_numpy
    loaded = load(val, val > THRE)
    _assert_counted(loaded)
    assert float(pg.occupied_fraction(loaded)) == float(np.mean(val > THRE, dtype=np.float32))


@pytest.mark.parametrize("S,V", [(1, 512), (4, 4096), (3, 4099)])
def test_k7_counts_are_the_masks(S, V):
    rng = np.random.default_rng(S)
    raw = torch.from_numpy(rng.normal(0, 0.2, (S, V)).astype(np.float32))
    val = torch.from_numpy(rng.random(V).astype(np.float32))
    args = (raw, val, "sdf", 0.027, 64.0, 0.95, THRE, None)
    new, mask, count, frac = got = occ_ema_update(*args)
    assert count.dtype == torch.int32 and int(count) == int(mask.sum())
    _assert_counted(OccGridState(new, mask, frac))
    assert all(torch.equal(a, b) for a, b in zip(got, occ_ema_update_plain(*args)))


def test_converge_occ_keeps_the_refresh_it_had():
    """The refresh as it was written before the count (its points, then K7's
    plain version): ``converge_occ`` gives the same bits."""
    renderer, _ = build_renderer(SMALL, device="cpu")
    accel = renderer.accels["cr"]
    st = converge_occ(accel, accel.init_state(), sdf_scene_tensor, n=3, it=1000, seed=0)
    gen = torch.Generator().manual_seed(0)
    val = accel.init_state().val
    R = accel.res
    ar = torch.arange(R)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1)
    mn, mx = accel.box("cpu")
    for _ in range(3):
        u = torch.rand(accel.jitter_shape, generator=gen)
        x = ((idx[None] + u) / R).reshape(-1, 3) * (mx - mn) + mn
        val, mask = occ_ema_update_plain(
            sdf_scene_tensor(x).reshape(accel.samples_per_voxel, -1), val.reshape(-1),
            accel.occ_val_fn, accel.raw_scale, accel.occ_inv_s, accel.ema_decay,
            accel.occ_thre, None)[:2]
        val = val.reshape((R,) * 3)
    assert torch.equal(st.val, val) and torch.equal(st.mask, mask.reshape((R,) * 3))
    _assert_counted(st)


def test_single_scene_trainer_reports_the_plain_mean_at_every_step():
    """Refreshes on every 2nd step: ``occ_frac`` is the plain mean of the
    grid's mask after each step, refreshed or not, and so is the fraction the
    grid's state keeps."""
    trainer, state = build_trainer(SMALL, device="cpu")
    rig = SyntheticObjectDataset(**SMALL["dataset_cfg"]["params"])
    rng, gen = np.random.default_rng(0), torch.Generator().manual_seed(0)
    fracs = []
    for _ in range(4):
        batch = to_device_batch(rig.sample_pixels(rng, N_RAYS), "cpu")
        state, m = trainer.train_step(state, batch, trainer.draw_noise(N_RAYS, gen, state.it))
        st = state.occ["cr"]
        assert torch.equal(m["occ_frac"], occupied_fraction_plain(st.mask))
        _assert_counted(st)
        fracs.append(float(m["occ_frac"]))
    assert state.it == 4 and all(0.0 < f < 1.0 for f in fracs)


def test_wrappers_refuse_what_the_kernels_do_not_take_off_the_cpu():
    """Off the CPU (the meta device stands for the card here) the wrappers
    check before any build or launch, and ``occupied_fraction`` returns the
    fraction a state keeps or refuses a state without one: no plain mean."""
    meta = torch.device("meta")
    box = (torch.zeros(3, device=meta), torch.ones(3, device=meta))
    for u in (torch.zeros((2, 4, 4, 3, 3), device=meta), torch.zeros((4, 4, 4, 3), device=meta),
              torch.zeros((1, 4, 4, 4, 3), dtype=torch.float64, device=meta)):
        with pytest.raises(ValueError, match="occ_voxel_points"):
            occ_voxel_points(u, *box)
    with pytest.raises(ValueError, match="box"):
        occ_voxel_points(torch.zeros((1, 4, 4, 4, 3), device=meta), box[0][:2], box[1])
    with pytest.raises(ValueError, match="lead"):
        occ_voxel_points(torch.zeros((1, 4, 4, 4, 3)), torch.zeros(3), torch.ones(3), "instance")
    raw = torch.zeros((2, 64), device=meta)
    for bad_raw, bad_val in ((raw, torch.zeros(63, device=meta)),
                             (raw.double(), torch.zeros(64, device=meta)),
                             (torch.zeros(64, device=meta), torch.zeros(64, device=meta))):
        with pytest.raises(ValueError, match="occ_ema_update"):
            occ_ema_update(bad_raw, bad_val, "sdf", 0.1, 64.0, 0.95, THRE, None)
    grid = OccGridEma(AABBSpace(), 4)
    mask = torch.zeros((4, 4, 4), dtype=torch.bool, device=meta)
    with pytest.raises(ValueError, match="carries its fraction"):
        grid.occupied_fraction(OccGridState(mask.float(), mask))
    frac = torch.zeros((), device=meta)
    assert grid.occupied_fraction(OccGridState(mask.float(), mask, frac)) is frac
