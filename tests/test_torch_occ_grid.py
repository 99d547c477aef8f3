"""Port parity for the EMA occupancy grid (``neuralsim_torch.accel.occ_grid``)
against ``neuralsim_tpu.accel.occ_grid`` on the CPU, at a small size: grid
16^3, 8 march segments, 64 rays, 8 samples.

Every random number is drawn with ``jax.random`` from the key the JAX function
gets and handed to the port as numpy: ``ray_proposal`` draws
``uniform(key, [N, n])`` inside ``sample_pdf``; ``update`` draws
``uniform(key, [S, R, R, R, 3])``.

Tolerances. Proposal depths: atol 1e-6, rtol 1e-5 (an empty segment weighs
1e-6 against 1, so nearly every cdf bin is near-empty, where the inverse CDF
turns a last-bit difference of the cdf into a depth shift; the two packages
sum the cdf in other orders). Grid values after an update: atol 1e-6 (two
sigmoids); the mask is ``val > occ_thre``, so it must agree exactly except
where ``|val - occ_thre|`` is under that tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.accel.occ_grid import OccGridEma as JaxGrid
from neuralsim_tpu.accel.occ_grid import OccGridState as JaxState
from neuralsim_tpu.fields.spatial import AABBSpace as JaxSpace
from neuralsim_torch.accel import OccGridEma, OccGridState
from neuralsim_torch.accel.occ_grid import occ_ema_update, occ_ray_proposal
from neuralsim_torch.bridge import occ_state_from_numpy
from neuralsim_torch.dataio.synthetic import _sdf_scene
from neuralsim_torch.fields.spatial import AABBSpace
from test_torch_render import _rays      # a frame of the rig and 16 rays that mostly miss

torch.set_num_threads(1)

R, M, N_SAMPLES = 16, 8, 8
T_TOL = dict(rtol=1e-5, atol=1e-6)
VAL_ATOL = 1e-6
# ema_decay 0.5: an empty voxel falls under the threshold after two updates
CFG = dict(occ_inv_s=64.0, march_steps=M, n_warmup_steps=0, ema_decay=0.5)


def _pair(**kw):
    cfg = {**CFG, **kw}
    return JaxGrid(JaxSpace(), R, **cfg), OccGridEma(AABBSpace(), R, **cfg)


def _scene_jax(x):
    return jnp.asarray(_sdf_scene(np.asarray(x)).astype(np.float32))


def _scene_torch(x):
    return torch.from_numpy(_sdf_scene(x.numpy()).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_state(got: OccGridState, want: JaxState, thre=0.3):
    val = np.asarray(want.val)
    np.testing.assert_allclose(got.val.numpy(), val, rtol=0, atol=VAL_ATOL)
    differ = got.mask.numpy() != np.asarray(want.mask)
    assert not np.any(differ & (np.abs(val - thre) > VAL_ATOL))
    assert got.val.dtype == torch.float32 and got.mask.dtype == torch.bool


@pytest.fixture(scope="module")
def converged():
    """Both grids after three updates against the scene's analytic SDF."""
    jg, pg = _pair()
    js, ps = jg.init_state(), pg.init_state()
    for i in range(3):
        key = jax.random.PRNGKey(i)
        js = jg.update(js, _scene_jax, key, 1000)
        ps = pg.update(ps, _scene_torch, _t(jax.random.uniform(key, (1, R, R, R, 3))), 1000)
    return jg, pg, js, ps


@pytest.mark.parametrize("m", [7, 8, 48, 64])
def test_segment_edges_are_jax_linspace_bit_for_bit(m):
    _, pg = _pair()
    np.testing.assert_array_equal(pg.edges01(m, "cpu").numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, m + 1)))


def test_init_state_and_voxel_size_match_jax():
    jg, pg = _pair()
    _assert_state(pg.init_state(), jg.init_state())
    np.testing.assert_allclose(pg.voxel_half_diag, float(jg.voxel_half_diag), rtol=1e-6)
    _, pe = _pair(init_occupied=False)
    assert not pe.init_state().mask.any() and float(pe.init_state().val.sum()) == 0.0


def test_update_matches_jax(converged):
    jg, pg, js, ps = converged
    _assert_state(ps, js)
    frac = float(pg.occupied_fraction(ps))
    assert 0.02 < frac < 0.6                       # the grid carved the scene out
    np.testing.assert_allclose(frac, float(jg.occupied_fraction(js)), atol=1.0 / R ** 3)


@pytest.mark.parametrize("kw", [dict(occ_val_fn="density"), dict(samples_per_voxel=3),
                                dict(n_warmup_steps=256)],
                         ids=["density", "three_samples", "warm_up"])
def test_update_variants_match_jax(kw):
    jg, pg = _pair(**kw)
    S = kw.get("samples_per_voxel", 1)
    fj, ft = _scene_jax, _scene_torch
    if "occ_val_fn" in kw:      # a density: large near the surface
        fj = lambda x: 40.0 * jnp.exp(-30.0 * jnp.abs(_scene_jax(x)))
        ft = lambda x: 40.0 * torch.exp(-30.0 * _scene_torch(x).abs())
    js, ps = jg.init_state(), pg.init_state()
    for i in range(4):
        key = jax.random.PRNGKey(10 + i)
        js = jg.update(js, fj, key, i)
        ps = pg.update(ps, ft, _t(jax.random.uniform(key, (S, R, R, R, 3))), i)
    _assert_state(ps, js)
    if "n_warmup_steps" in kw:  # the floor keeps every voxel occupied
        assert ps.mask.all() and float(ps.val.min()) >= np.float32(0.3 + 1e-3)
    else:
        assert 0 < int(ps.mask.sum()) < R ** 3


def test_update_refuses_a_wrong_jitter():
    _, pg = _pair()
    with pytest.raises(ValueError, match="voxel jitter"):
        pg.update(pg.init_state(), _scene_torch, torch.zeros(2, R, R, R, 3), 0)
    with pytest.raises(ValueError, match="voxel jitter"):
        pg.update(pg.init_state(), _scene_torch, None, 0)


@pytest.mark.parametrize("it", [0, 5, 16, 31, 32])
def test_maybe_update_follows_the_cadence(converged, it):
    jg, pg, js, ps = converged
    key = jax.random.PRNGKey(99)
    # JAX traces the field under lax.cond, so a slab that both packages
    # evaluate with the same two exact operations stands in for the scene
    want = jg.maybe_update(js, lambda x: jnp.abs(x[..., 0]) - 0.3, key, it)
    got = pg.maybe_update(ps, lambda x: x[..., 0].abs() - 0.3,
                          _t(jax.random.uniform(key, (1, R, R, R, 3))), it)
    _assert_state(got, want)
    assert (got is ps) == (it % 16 != 0)           # off the cadence the state is untouched


def test_occupancy_at_matches_jax(converged):
    jg, pg, js, ps = converged
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.3, 1.3, (4000, 3)).astype(np.float32)
    x[:8] = [[1, 1, 1], [-1, -1, -1], [1, 0, 0], [0, -1, 0], [0.45, 0, 0], [1.0001, 0, 0],
             [0, 0, 0], [0.999999, 0.5, -0.5]]
    got = pg.occupancy_at(ps, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.occupancy_at(js, jnp.asarray(x))))
    assert got.any() and not got.all()


@pytest.mark.parametrize("noisy", [False, True], ids=["deterministic", "noise"])
def test_ray_proposal_matches_jax(converged, noisy):
    jg, pg, js, ps = converged
    o, d = _rays()
    n_, f_, hit = jg.space.ray_test(jnp.asarray(o), jnp.asarray(d))
    key = jax.random.PRNGKey(5) if noisy else None
    want, want_valid = jg.ray_proposal(js, jnp.asarray(o), jnp.asarray(d), n_, f_, N_SAMPLES,
                                       key=key)
    noise = _t(jax.random.uniform(key, (o.shape[0], N_SAMPLES))) if noisy else None
    got, valid = pg.ray_proposal(ps, _t(o), _t(d), _t(n_), _t(f_), N_SAMPLES, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **T_TOL)
    assert valid.all() and valid.dtype == torch.bool and np.asarray(want_valid).all()
    assert 5 < int(np.asarray(hit).sum()) < o.shape[0]         # hits and misses both
    hit_t = got[np.asarray(hit)]
    assert (hit_t[:, 1:] >= hit_t[:, :-1]).all()               # ascending


def test_ray_proposal_concentrates_samples_in_occupied_cells(converged):
    _, pg, _, ps = converged
    o, d = _rays()
    o, d = _t(o), _t(d)
    n_, f_, hit = pg.space.ray_test(o, d)
    t, _ = pg.ray_proposal(ps, o, d, n_, f_, N_SAMPLES)
    x = o[:, None] + t[..., None] * d[:, None]
    occ = pg.occupancy_at(ps, x)
    edges = n_[:, None] + (f_ - n_)[:, None] * pg.edges01(M, "cpu")
    mid = 0.5 * (edges[:, 1:] + edges[:, :-1])
    touches = pg.occupancy_at(ps, o[:, None] + mid[..., None] * d[:, None]).any(-1)
    assert touches.any() and (~touches & hit).any()
    # a ray whose march touches the grid has every sample in a marched-occupied
    # segment; a cell is smaller than a segment, so most (not all) samples also
    # lie in occupied cells
    assert occ[touches].float().mean() > 0.5
    # a ray that touches nothing falls back to uniform samples over [near, far]
    u = (t[~touches & hit] - n_[~touches & hit, None]) / (f_ - n_)[~touches & hit, None]
    np.testing.assert_allclose(u.numpy(), np.broadcast_to((np.arange(8) + 0.5) / 8, u.shape),
                               atol=1e-5)


@pytest.mark.parametrize("full", [False, True], ids=["empty_grid", "full_grid"])
def test_ray_proposal_on_an_empty_and_a_full_grid_is_uniform(full):
    jg, pg = _pair(init_occupied=full)
    o, d = _rays()
    n_, f_, _ = jg.space.ray_test(jnp.asarray(o), jnp.asarray(d))
    key = jax.random.PRNGKey(6)
    want, _ = jg.ray_proposal(jg.init_state(), jnp.asarray(o), jnp.asarray(d), n_, f_,
                              N_SAMPLES, key=key)
    got, _ = pg.ray_proposal(pg.init_state(), _t(o), _t(d), _t(n_), _t(f_), N_SAMPLES,
                             noise=_t(jax.random.uniform(key, (o.shape[0], N_SAMPLES))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **T_TOL)


def test_ray_proposal_with_probes_outside_the_box(converged):
    """near/far beyond the box: probes outside count as empty."""
    jg, pg, js, ps = converged
    o, d = _rays()
    near = np.full(o.shape[0], 0.1, np.float32)
    far = np.full(o.shape[0], 6.0, np.float32)
    want, _ = jg.ray_proposal(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(near),
                              jnp.asarray(far), N_SAMPLES, march_steps=48)
    got, _ = pg.ray_proposal(ps, _t(o), _t(d), _t(near), _t(far), N_SAMPLES, march_steps=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **T_TOL)


def test_wrappers_take_the_plain_versions_on_the_cpu(converged):
    _, pg, _, ps = converged
    from neuralsim_torch.accel.occ_grid import K4, K7
    n4, n7 = K4.launches, K7.launches
    o, d = _rays()
    t = occ_ray_proposal(_t(o), _t(d), torch.zeros(len(o)), torch.ones(len(o)), ps.mask,
                         *pg.box("cpu"), pg.edges01(M, "cpu"), 4)
    val, mask = occ_ema_update(torch.zeros(2, 10), torch.full((10,), 0.5), "sdf", 0.1, 64.0,
                               0.95, 0.3, None)[:2]
    assert t.shape == (len(o), 4) and bool(mask.all()) and val.shape == (10,)
    assert (K4.launches, K7.launches) == (n4, n7)        # no kernel launch on the CPU


def test_bridge_carries_the_grid_state(converged):
    _, pg, js, ps = converged
    st = occ_state_from_numpy(np.asarray(js.val), np.asarray(js.mask))
    _assert_state(st, js)
    assert torch.equal(st.mask, ps.mask) or float((st.val - ps.val).abs().max()) <= VAL_ATOL
    with pytest.raises(ValueError):
        occ_state_from_numpy(np.zeros((4, 4, 4)), np.zeros((4, 4), bool))


# ---------------------------------------------------------------------------
# K4's draws: the bin found by the clip test, then the prefix form
# ---------------------------------------------------------------------------

F32 = np.float32


def _cdf_and_lengths(occ, edges):
    """The kernel's per-ray cdf [N, M+1] and lengths [N, M] in float32: the
    weights (occupied 1, or all 1 where nothing is occupied) + 1e-6 summed
    from the left, each sum divided by the total; len_i = e_{i+1} - e_i."""
    N, M = occ.shape
    miss = (~occ.any(-1)).astype(F32)
    csum = np.zeros((N, M + 1), F32)
    for i in range(M):
        w = (occ[:, i].astype(F32) + miss) + F32(1e-6)
        csum[:, i + 1] = csum[:, i] + w
    cdf = csum / csum[:, -1:]
    cdf[:, 0] = 0.0
    return cdf, edges[:, 1:] - edges[:, :-1]


def _seg(u, c0, c1):
    return np.clip((u - c0) / np.maximum(c1 - c0, F32(1e-12)), F32(0), F32(1))


def _parent_walk(cdf, lens, first, u):
    """The earlier kernel: every segment's clipped step, summed from the left."""
    acc = np.zeros(u.shape, F32)
    for i in range(lens.shape[1]):
        acc = acc + _seg(u, cdf[:, i, None], cdf[:, i + 1, None]) * lens[:, i, None]
    return first[:, None] + acc


def _step_is_one(u, c0, c1):
    """The clip test's seg == 1 as the kernel evaluates it, without the
    divide: u - c0 >= max(c1 - c0, 1e-12)."""
    return (u - c0) >= np.maximum(c1 - c0, F32(1e-12))


def _clip_test_search(cdf, lens, first, u):
    """The kernel's form: b, the first segment whose clipped step is below 1
    (binary search with _step_is_one), then first + (P_b + seg_b len_b), P
    the prefix of the lengths from the left (P_M where every step is 1)."""
    N, M = lens.shape
    P = np.zeros((N, M + 1), F32)
    for i in range(M):
        P[:, i + 1] = P[:, i] + lens[:, i]
    rows = np.broadcast_to(np.arange(N)[:, None], u.shape)
    b, cnt = np.zeros(u.shape, np.int64), np.full(u.shape, M)
    while (cnt > 0).any():
        h = cnt >> 1
        i = np.minimum(b + h, M - 1)
        one = (cnt > 0) & _step_is_one(u, cdf[rows, i], cdf[rows, i + 1])
        b = np.where(one, b + h + 1, b)
        cnt = np.where(cnt > 0, np.where(one, cnt - h - 1, h), 0)
    bi = np.minimum(b, M - 1)
    last = P[rows, b] + _seg(u, cdf[rows, bi], cdf[rows, bi + 1]) * lens[rows, bi]
    return first[:, None] + np.where(b < M, last, P[rows, b])


K4_BIN_CASES = [("M 48, 30% occupied", 48, 16, 0.3, "noise"),
                ("M 64, 30% occupied", 64, 32, 0.3, "noise"),
                ("33+ occupied", 64, 32, 0.85, "noise"),
                ("33+ occupied, midpoints", 64, 32, 0.85, "midpoints"),
                ("uniform fallback", 64, 32, 0.0, "noise"),
                ("full, midpoints on cdf values", 64, 32, 1.0, "midpoints"),
                ("draws on cdf values", 64, 32, 0.5, "on cdf")]


@pytest.mark.parametrize("case", K4_BIN_CASES, ids=[c[0] for c in K4_BIN_CASES])
def test_k4_bin_by_the_clip_test_is_the_sequential_walk_bit_for_bit(case):
    """K4 finds a draw's bin by the plain clip test and returns e_0 + (P_b +
    seg_b len_b); emulated in float32, that is the earlier kernel's
    sequential walk bit for bit: with rays past 32 occupied segments (where
    an empty segment's 1e-6 is lost and the cdf has steps of 0), the
    uniform fallback, and draws exactly on cdf values."""
    _, M, n, share, draws = case
    rng = np.random.default_rng(M + int(share * 100))
    N = 512
    occ = rng.random((N, M)) < share
    near = rng.uniform(0.0, 2.0, N).astype(F32)
    span = rng.uniform(0.1, 5.0, N).astype(F32)
    lin = np.append(np.arange(M, dtype=F32) * (F32(1) / F32(M)), F32(1))
    edges = near[:, None] + span[:, None] * lin
    cdf, lens = _cdf_and_lengths(occ, edges)
    if draws == "noise":
        u = (np.arange(n, dtype=F32) + rng.random((N, n)).astype(F32)) * (F32(1) / F32(n))
    elif draws == "midpoints":
        u = np.broadcast_to(((np.arange(n) + 0.5) / n).astype(F32), (N, n)).copy()
    else:
        u = cdf[np.arange(N)[:, None], rng.integers(0, M + 1, (N, n))]
    u[:, -1] = np.where(rng.random(N) < 0.1, F32(1), u[:, -1])     # past the last bin
    if 0.85 <= share < 1:
        assert (np.diff(cdf, axis=-1) == 0).any(-1).mean() > 0.5     # steps of 0
    if draws != "noise" and share >= 0.5:
        assert np.isin(u, cdf).any()                                  # draws on cdf values
    want = _parent_walk(cdf, lens, edges[:, 0], u)
    got = _clip_test_search(cdf, lens, edges[:, 0], u)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    c0, c1 = cdf[:, None, :-1], cdf[:, None, 1:]
    assert np.array_equal(_step_is_one(u[..., None], c0, c1),
                          _seg(u[..., None], c0, c1) >= 1)


def test_k4_clip_test_without_its_divide():
    """clip((u - c0) / max(c1 - c0, 1e-12), 0, 1) >= 1 exactly where
    u - c0 >= max(c1 - c0, 1e-12), in float32: on pairs a few ulps apart
    around the quotient 1, at powers of two, at the 1e-12 clamp, and NaN."""
    rng = np.random.default_rng(3)
    c0 = rng.random(20000).astype(F32) * F32(0.9)
    step = np.concatenate([rng.random(5000) * 1e-3, 2.0 ** -rng.integers(1, 40, 5000),
                           np.zeros(5000), rng.random(5000)]).astype(F32)
    c1 = np.minimum(c0 + step, F32(1))
    den = np.maximum(c1 - c0, F32(1e-12))
    ulps = rng.integers(-4, 5, c0.size).astype(np.int32)
    x = (den.view(np.int32) + ulps).view(F32)          # u - c0 a few ulps from den
    u = np.concatenate([c0 + x, c0 + den, c1, c0, np.array([np.nan], F32)]).astype(F32)
    c0, c1 = (np.concatenate([a, a, a, a, a[:1]]) for a in (c0, c1))
    want = _seg(u, c0, c1) >= 1
    assert np.array_equal(_step_is_one(u, c0, c1), want) and want.any() and not want.all()
