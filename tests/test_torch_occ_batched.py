"""Port parity for the per-instance and per-keyframe occupancy grids
(``OccGridEmaBatched``, ``OccGridEmaDynamic`` of ``neuralsim_torch.accel``,
on K10's and K7's plain versions) against ``neuralsim_tpu.accel.occ_grid``
on the CPU, at a small size: 3 instances or keyframes of 16^3, 8 march
segments, 8 samples, a frame of the synthetic rig's rays.

Both packages start from the same state (``bridge.grid_state_from_numpy``)
and get the same draws: the update's voxel jitter ``uniform(key, [G, R, R, R,
3])`` and the proposal's ``uniform(key, [N, n])``, drawn with ``jax.random``
and handed to the port as numpy. The field values are an analytic SDF per
instance (spheres of three radii) and per time (a sphere moving with t),
evaluated in numpy on the points each package computed, so the arithmetic
under test is the grids' own. Held exactly: the initial states, the points of
an update, ``occupancy_at``, and the proposal depths from the same draws (the
plain versions repeat the JAX package's operations in its order). Two
tolerances, each the single-grid test's (test_torch_occ_grid.py) for the same
reason: the values of an update within 1e-6 (measured 2.4e-7 on 2 of 12,288
voxels: the occupancy is a sigmoid, and torch's exp and XLA's differ in their
last bit), their masks equal except within that distance of the threshold;
the deterministic proposal (no draws) within atol 1e-6 / rtol 1e-5 (measured
2.4e-7: its stratum midpoints come from ``jnp.linspace``, whose last bits
differ even between JAX's eager and jitted runs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.accel.occ_grid import OccGridEmaBatched as JaxBatched
from neuralsim_tpu.accel.occ_grid import OccGridEmaDynamic as JaxDynamic
from neuralsim_tpu.fields.spatial import AABBSpace as JaxSpace
from neuralsim_torch.accel import OccGridEmaBatched, OccGridEmaDynamic
from neuralsim_torch.accel.occ_grid import K4, K10
from neuralsim_torch.bridge import grid_state_from_numpy
from neuralsim_torch.fields.spatial import AABBSpace
from test_torch_render import _rays      # a frame of the rig and 16 rays that mostly miss

torch.set_num_threads(1)

G, R, M, N_SAMPLES = 3, 16, 8, 8
CFG = dict(occ_inv_s=64.0, march_steps=M, n_warmup_steps=0, ema_decay=0.5)
RADII = np.array([0.3, 0.5, 0.7])
VAL_ATOL = 1e-6
T_TOL = dict(rtol=1e-5, atol=1e-6)


def _sphere_b(x, b):
    """Instance b's SDF: a sphere of radius RADII[b] at the origin."""
    x, b = np.asarray(x, np.float64), np.asarray(b)
    return (np.linalg.norm(x, axis=-1) - RADII[b]).astype(np.float32)


def _sphere_t(x, t01):
    """A sphere of radius 0.4 moving along x with the time."""
    x, t01 = np.asarray(x, np.float64), np.asarray(t01, np.float64)
    c = np.stack([1.2 * t01 - 0.6, np.zeros_like(t01), np.zeros_like(t01)], -1)
    return (np.linalg.norm(x - c, axis=-1) - 0.4).astype(np.float32)


def _jax_fn(f):
    return lambda x, b: jnp.asarray(f(x, b))


def _torch_fn(f):
    return lambda x, b: torch.from_numpy(f(x.numpy(), b.numpy()))


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_state(got, want, thre=0.3):
    val = np.asarray(want.val)
    np.testing.assert_allclose(got.val.numpy(), val, rtol=0, atol=VAL_ATOL)
    differ = got.mask.numpy() != np.asarray(want.mask)
    assert not np.any(differ & (np.abs(val - thre) > VAL_ATOL))
    assert got.val.dtype == torch.float32 and got.mask.dtype == torch.bool


def _pairs(kind):
    if kind == "batched":
        return (JaxBatched(JaxSpace(), G, R, **CFG), OccGridEmaBatched(AABBSpace(), G, R, **CFG),
                _sphere_b)
    return (JaxDynamic(JaxSpace(), R, n_keyframes=G, **CFG),
            OccGridEmaDynamic(AABBSpace(), R, n_keyframes=G, **CFG), _sphere_t)


@pytest.fixture(scope="module", params=["batched", "dynamic"])
def grids(request):
    """Both grids after three updates from the same initial state."""
    jg, pg, f = _pairs(request.param)
    js, ps = jg.init_state(), pg.init_state()
    np.testing.assert_array_equal(ps.val.numpy(), np.asarray(js.val))
    for i in range(3):
        key = jax.random.PRNGKey(i)
        js = jg.update(js, _jax_fn(f), key, 1000)
        ps = pg.update(ps, _torch_fn(f), _t(jax.random.uniform(key, (G, R, R, R, 3))), 1000)
    return request.param, jg, pg, js, ps


def test_init_state_matches_jax():
    for kind in ("batched", "dynamic"):
        jg, pg, _ = _pairs(kind)
        for a, b in zip(pg.init_state(), jg.init_state()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert pg.init_state().val.shape == (G, R, R, R) and pg.jitter_shape == (G, R, R, R, 3)


def test_update_matches_jax(grids):
    kind, jg, pg, js, ps = grids
    _assert_state(ps, js)
    frac = ps.mask.float().mean(dim=(1, 2, 3))
    assert bool((frac > 0.01).all()) and bool((frac < 0.6).all())
    if kind == "batched":                     # the three radii carve three grids
        assert bool((frac[1:] > frac[:-1]).all())
    else:                                     # the sphere moves between keyframes
        assert not torch.equal(ps.mask[0], ps.mask[-1])


def test_update_in_the_warm_up_matches_jax():
    """From the bridge's copy of a JAX state, one update inside the warm-up
    (the floor keeps every voxel occupied) and one after it."""
    for kind in ("batched", "dynamic"):
        jg, pg, f = _pairs(kind)
        jg.n_warmup_steps = pg.n_warmup_steps = 256
        rng = np.random.default_rng(1)
        val = rng.random((G, R, R, R)).astype(np.float32)
        js = jg.init_state()._replace(val=jnp.asarray(val), mask=jnp.asarray(val > 0.3))
        ps = grid_state_from_numpy(val, val > 0.3)
        for it in (5, 300):
            key = jax.random.PRNGKey(it)
            js = jg.update(js, _jax_fn(f), key, it)
            ps = pg.update(ps, _torch_fn(f), _t(jax.random.uniform(key, (G, R, R, R, 3))), it)
            _assert_state(ps, js)
            assert bool(ps.mask.all()) == (it < 256)


def test_occupancy_at_matches_jax(grids):
    kind, jg, pg, js, ps = grids
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.3, 1.3, (3000, 3)).astype(np.float32)
    lead = rng.integers(-1, G + 1, 3000) if kind == "batched" else \
        rng.uniform(-0.2, 1.2, 3000).astype(np.float32)
    got = pg.occupancy_at(ps, _t(x), _t(lead)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.occupancy_at(js, jnp.asarray(x),
                                                                   jnp.asarray(lead))))
    np.testing.assert_array_equal(pg.occupancy_at(ps, _t(x)).numpy(),
                                  np.asarray(jg.occupancy_at(js, jnp.asarray(x))))
    assert got.any() and not got.all()


@pytest.mark.parametrize("case", ["deterministic", "noise", "outside", "wild_lead"])
def test_ray_proposal_matches_jax(grids, case):
    """K10's plain version: each ray's own grid (random instances or times),
    with and without noise, probes outside the box, and (batched) grid
    indices outside [0, G), clipped into the flat grids as JAX's take."""
    kind, jg, pg, js, ps = grids
    o, d = _rays()
    n = o.shape[0]
    near, far, hit = jg.space.ray_test(jnp.asarray(o), jnp.asarray(d))
    if case == "outside":
        near, far = jnp.full((n,), 0.1), jnp.full((n,), 6.0)
    rng = np.random.default_rng(4)
    if kind == "batched":
        lead = rng.integers(-2, G + 2, n) if case == "wild_lead" else rng.integers(0, G, n)
        lead = lead.astype(np.int32)
        call_j = lambda **kw: jg.ray_proposal_batched(js, jnp.asarray(o), jnp.asarray(d), near,
                                                      far, N_SAMPLES, jnp.asarray(lead), **kw)
        call_p = lambda **kw: pg.ray_proposal_batched(ps, _t(o), _t(d), _t(near), _t(far),
                                                      N_SAMPLES, _t(lead), **kw)
    else:
        t01 = rng.uniform(-0.2, 1.2, n).astype(np.float32)
        call_j = lambda **kw: jg.ray_proposal_dynamic(js, jnp.asarray(o), jnp.asarray(d), near,
                                                      far, N_SAMPLES, jnp.asarray(t01), **kw)
        call_p = lambda **kw: pg.ray_proposal_dynamic(ps, _t(o), _t(d), _t(near), _t(far),
                                                      N_SAMPLES, _t(t01), **kw)
    key = jax.random.PRNGKey(5) if case != "deterministic" else None
    want, want_valid = call_j(key=key)
    noise = None if key is None else _t(jax.random.uniform(key, (n, N_SAMPLES)))
    n4, n10 = K4.launches, K10.launches
    got, valid = call_p(noise=noise)
    assert (K4.launches, K10.launches) == (n4, n10)      # no kernel launch on the CPU
    if noise is None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **T_TOL)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert valid.all() and np.asarray(want_valid).all()
    assert 5 < int(np.asarray(hit).sum()) < n


def test_the_grid_index_picks_the_grid(grids):
    """A ray of index g marches grid g: the same as a single grid holding
    that grid's state. (An index outside [0, G) clips the flat probe index,
    not the grid: test_ray_proposal_matches_jax[wild_lead].)"""
    from neuralsim_torch.accel import OccGridEma, OccGridState
    _, _, pg, _, ps = grids
    o, d = (_t(a) for a in _rays())
    n = o.shape[0]
    near, far, _ = pg.space.ray_test(o, d)
    noise = torch.rand((n, N_SAMPLES), generator=torch.Generator().manual_seed(0))
    single = OccGridEma(AABBSpace(), R, **CFG)
    runs = []
    for g in range(G):
        got = pg.ray_proposal(ps, o, d, near, far, N_SAMPLES, noise,
                              lead=torch.full((n,), g, dtype=torch.int32))[0]
        want = single.ray_proposal(OccGridState(ps.val[g], ps.mask[g]), o, d, near, far,
                                   N_SAMPLES, noise)[0]
        assert torch.equal(got, want), g
        runs.append(got)
    assert any(not torch.equal(runs[0], r) for r in runs[1:])


def test_bridge_refuses_a_single_grid_state():
    with pytest.raises(ValueError):
        grid_state_from_numpy(np.zeros((4, 4, 4)), np.zeros((4, 4, 4), bool))
    st = grid_state_from_numpy(np.zeros((2, 4, 4, 4)), np.ones((2, 4, 4, 4), bool))
    assert st.val.dtype == torch.float32 and bool(st.mask.all())
