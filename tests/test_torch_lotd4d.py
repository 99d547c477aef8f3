"""Port parity: the LoTD encoding on 4-D inputs (the distant field's
contracted points), the plain version of K3 in four dimensions against the
JAX package on the CPU. The CUDA kernel is held to this plain version in
test_torch_kernels_cuda.py.

A small ladder with both level types in 4-D: 4 levels of 2 features from
resolution 4 to 32 on 2^10 rows (``ngp_levels``: (4+1)^4 = 625 rows fit, so
level 0 is dense; the others hash). The rows of every corner are held exactly
(integers: the dense row and the uint32 hash), the features and the table's
gradient within 1e-5 relative (only the float32 summation order may differ),
on random points and on the edges: points on cell faces, at 0 and 1 and
outside [0, 1] (clipped) in every coordinate, the fourth included.

The kernels' premises, on JAX's rows for every level of this ladder and of
the StreetSurf distant field's: the two corners of a point that differ on
axis 0 alone fall on rows r, r ^ 1 (hash, cell_0 even), r, r ^ 3 (cell_0 1
mod 4) or r, r + 1 (dense), in one 32-byte sector of a [size, 2] copy placed
on 32 bytes (exactly; the sector test where the kernels assume it). The
backward's layout (the gradient scratch of [size, F] rows, some levels past
it) is held to the plain gradient and to JAX's at 1e-5 of the largest entry
(the same terms in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.encodings.lotd import make_lotd as jax_make_lotd
from neuralsim_tpu.fields.encodings.lotd import ngp_levels as jax_ngp_levels
from neuralsim_torch.fields.encodings.lotd import (Grid4BwdPlan, grid_bwd_places, grid_bwd_plan,
                                                   grid_corner_rows, grid_fwd_places,
                                                   grid_fwd_plan, lotd_grid,
                                                   lotd_grid_bwd_layout_plain,
                                                   lotd_grid_bwd_plain, make_lotd, ngp_levels)

torch.set_num_threads(1)

SMALL4 = {"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2, "log2_hashmap_size": 10}
# the distant field of configs/waymo_streetsurf.yaml (its plans and corner rows only: its
# table is 2.5 M floats)
STREETSURF4 = {"n_levels": 10, "base_res": 16, "max_res": 1024, "log2_hashmap_size": 17}
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(cfg=SMALL4, seed=0):
    jenc = jax_make_lotd(cfg, input_dim=4)
    table = np.asarray(jenc.init(jax.random.PRNGKey(seed))["table"])
    rng = np.random.default_rng(seed)
    table = (table + rng.normal(0.0, 0.3, table.shape)).astype(np.float32)
    penc = make_lotd(cfg, input_dim=4)
    with torch.no_grad():
        penc.table.copy_(torch.from_numpy(table))
    return jenc, penc, table


def edge_points(n=512, seed=1, res=(4, 8, 16, 32)):
    """Random points in [0, 1]^4, then in each coordinate in turn: cell faces
    of every level (k / res), 0, 1 and points outside [0, 1]."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 4)).astype(np.float32)
    faces = np.unique(np.concatenate([np.arange(r + 1, dtype=np.float32) / np.float32(r)
                                      for r in res]))
    special = np.concatenate([faces, np.float32([0.0, 1.0, -0.25, 1.5, 1e-7, 1 - 1e-7])])
    at = 0
    for ax in range(4):
        m = len(special)
        x[at:at + m, ax] = special
        at += m
    x[at:at + 4] = np.float32([[0, 0, 0, 0], [1, 1, 1, 1], [1, 0, 1, 0], [-1, 2, 0.5, 1]])
    return x


def test_4d_level_plan_matches_jax():
    for cfg in (SMALL4, STREETSURF4):
        args = (cfg["n_levels"], cfg.get("n_feats", 2), cfg["log2_hashmap_size"],
                cfg["base_res"], cfg["max_res"], 4)
        assert ngp_levels(*args) == jax_ngp_levels(*args)
    jenc, penc, _ = _pair()
    assert [(s.res, s.n_feats, s.typ, s.size, s.offset) for s in jenc.specs] == \
        [(s.res, s.n_feats, s.typ, s.size, s.offset) for s in penc.specs]
    assert [s.typ for s in penc.specs] == ["dense", "hash", "hash", "hash"]
    assert penc.input_dim == 4 and penc.out_dim == jenc.out_dim == 8


def test_streetsurf_distant_ladder_and_its_plans():
    """The YAML's distant encoding: level 0 dense at 17^4 = 83,521 rows, 9
    hash levels of 2^17; K3's forward stages none in shared memory (every
    level interleaved into the scratch, each from a 32-byte boundary) and
    its backward sums none there (every level's gradient in its scratch,
    at the forward's places)."""
    enc = make_lotd(STREETSURF4, input_dim=4)
    assert [s.typ for s in enc.specs] == ["dense"] + ["hash"] * 9
    assert enc.specs[0].size == 17 ** 4 and all(s.size == 2 ** 17 for s in enc.specs[1:])
    assert enc.grid_fwd_plan.stage_mask == 0 and enc.grid_fwd_plan.n_shared == 0
    assert enc.grid_fwd_plan.n_inter == sum((s.size * 2 + 7) // 8 * 8 for s in enc.specs)
    assert enc.grid_bwd_plan == Grid4BwdPlan(enc.grid_fwd_plan.n_inter)
    assert enc.grid_bwd_plan.private_mask == enc.grid_bwd_plan.n_private == 0
    assert enc.grid_bwd_plan.at(262_144) == enc.grid_bwd_plan
    rows = enc._grid_meta.tolist()
    assert grid_fwd_plan(rows) == enc.grid_fwd_plan
    assert grid_bwd_plan(rows, 4) == enc.grid_bwd_plan
    assert grid_bwd_places(rows, enc.grid_bwd_plan) == grid_fwd_places(rows, enc.grid_fwd_plan)
    # the dense level's 167,042 floats end 16 bytes into a sector; the hash
    # levels after it start on the next one
    assert [off for _, off in grid_fwd_places(rows, enc.grid_fwd_plan)][:2] == [0, 167_048]


def test_4d_cp_level_raises_naming_it():
    with pytest.raises(NotImplementedError, match="CP level of a 4-D"):
        make_lotd({"levels": [(8, 2, "dense"), (64, 2, "cp")]}, input_dim=4)
    with pytest.raises(NotImplementedError, match="5-D"):
        make_lotd(SMALL4, input_dim=5)


@pytest.mark.parametrize("li", [0, 1, 3])
def test_corner_rows_are_jax_rows_exactly(li):
    jenc, penc, _ = _pair()
    spec = jenc.specs[li]
    x = np.clip(edge_points(), 0.0, 1.0)
    pos = jnp.asarray(x).T * spec.res
    cell = jnp.minimum(jnp.floor(pos), spec.res - 1)
    frac = pos - cell
    want = np.stack([np.asarray(jenc._corner_rows_weight(cell.astype(jnp.int32), frac, c,
                                                         spec)[0]) for c in range(16)])
    posp = torch.from_numpy(x).T * spec.res
    cellp = torch.clamp(torch.floor(posp), max=spec.res - 1).long()
    got = grid_corner_rows(cellp, spec.res, spec.size, spec.typ == "hash").numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.min() >= 0 and got.max() < spec.size
    if spec.typ == "hash":      # the fourth prime, 3674653429, wraps past int32
        assert np.any(np.asarray(cell)[3] > 0)


@pytest.mark.parametrize("cfg", ["SMALL4", "STREETSURF4"])
def test_axis0_corner_pairs_share_rows_and_sectors(cfg):
    """The premise of K3-4D's backward pairs and of its forward's sectors,
    on JAX's own rows: corners c and c | 1 differ on axis 0 alone, whose
    hash prime is 1, and each level's size is a power of two, so their rows
    are r and r ^ 1 where cell_0 is even and r and r ^ 3 where cell_0 is 1
    mod 4 (the dense rows r and r + 1). At F 2 a [size, 2] copy from a
    32-byte place holds 4 rows a sector: such a pair shares one (a dense
    pair unless r is 3 mod 4), and r, r ^ 1 is one aligned 16 bytes (the
    backward's float4). The port's rows are JAX's, exactly."""
    c = {"SMALL4": SMALL4, "STREETSURF4": STREETSURF4}[cfg]
    jenc = jax_make_lotd(c, input_dim=4)
    penc = make_lotd(c, input_dim=4)
    # every level in the scratch (the backward's places; the forward's where
    # nothing is staged, as for the distant ladder)
    places = grid_bwd_places(penc._grid_meta.tolist(), penc.grid_bwd_plan)
    assert all(where == "scratch" and off % 8 == 0 for where, off in places)
    res = [s.res for s in jenc.specs]
    x = np.clip(np.concatenate([edge_points(4 * sum(r + 8 for r in res), seed=8, res=res),
                                np.random.default_rng(9).random((4096, 4), np.float32)]),
                0.0, 1.0)
    for spec, (where, off) in zip(jenc.specs, places):
        pos = jnp.asarray(x).T * spec.res
        cell = jnp.minimum(jnp.floor(pos), spec.res - 1)
        frac = pos - cell
        want = np.stack([np.asarray(jenc._corner_rows_weight(cell.astype(jnp.int32), frac, k,
                                                             spec)[0]) for k in range(16)])
        cellp = torch.clamp(torch.floor(torch.from_numpy(x).T * spec.res), max=spec.res - 1)
        np.testing.assert_array_equal(
            grid_corner_rows(cellp.long(), spec.res, spec.size, spec.typ == "hash").numpy(),
            want.astype(np.int64))
        c0 = np.asarray(cell)[0].astype(np.int64)
        for k in range(0, 16, 2):
            r0, r1 = want[k].astype(np.int64), want[k + 1].astype(np.int64)
            sector = lambda r: (off + 2 * r) * 4 // 32
            if spec.typ == "dense":
                np.testing.assert_array_equal(r1, r0 + 1)
                same = r0 % 4 != 3
            else:
                even, one = c0 % 2 == 0, c0 % 4 == 1
                np.testing.assert_array_equal(r1[even], r0[even] ^ 1)
                np.testing.assert_array_equal(r1[one], r0[one] ^ 3)
                same = even | one
                assert even.any() and one.any() and (~same).any()
            np.testing.assert_array_equal(sector(r0)[same], sector(r1)[same])
            pair = (r0 ^ r1) == 1
            assert np.all((r0[pair] & ~1) * 2 % 4 == 0)     # the pair's first float on 16 bytes


@pytest.mark.parametrize("plan", ["own", "first two levels", "no scratch"])
def test_backward_layout_matches_the_plain_gradient_and_jax(plan):
    """K3-4D's backward as the kernel lays it out (lotd_grid_bwd_layout_plain:
    each level's corners added into its [size, F] rows in the gradient
    scratch, a level past it into the table's [F, size] segment, then the
    scratch written into the table) against the plain version and JAX's
    autodiff, within 1e-5 of the largest entry: the same terms summed in
    another order (corner by corner into rows, not autograd's)."""
    jenc, penc, table = _pair()
    rows = penc._grid_meta.tolist()
    p = {"own": penc.grid_bwd_plan, "no scratch": Grid4BwdPlan(0),
         "first two levels": Grid4BwdPlan(sum((r[1] * r[3] + 7) // 8 * 8 for r in rows[:2]))}[plan]
    assert [w for w, _ in grid_bwd_places(rows, p)].count("scratch") == \
        {"own": 4, "first two levels": 2, "no scratch": 0}[plan]
    x = edge_points(384, seed=11)
    cot = np.random.default_rng(12).normal(size=(x.shape[0], penc.out_dim)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(jenc({"table": t}, jnp.asarray(x))
                                                 * jnp.asarray(cot)))(jnp.asarray(table)))
    d_out = torch.from_numpy(cot).T.contiguous()
    got = lotd_grid_bwd_layout_plain(penc.total_params, torch.from_numpy(x), rows, p, d_out)
    plain = lotd_grid_bwd_plain(penc.total_params, torch.from_numpy(x), penc._grid_meta, d_out,
                                None)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=tol)


def test_features_match_jax():
    jenc, penc, table = _pair()
    x = edge_points()
    want = np.asarray(jenc({"table": jnp.asarray(table)}, jnp.asarray(x)))
    with torch.no_grad():
        got = penc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want).max() > 0.1


def test_jacobian_matches_jax():
    jenc, penc, table = _pair()
    x = edge_points(256, seed=3)
    jf, jj = jenc.with_jacobian({"table": jnp.asarray(table)}, jnp.asarray(x))
    with torch.no_grad():
        pf, pj = penc.with_jacobian(torch.from_numpy(x))
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), **TOL)
    np.testing.assert_allclose(pj.numpy(), np.asarray(jj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(jj)).max()))
    assert pj.shape == (256, 8, 4)


def test_table_gradient_matches_jax():
    jenc, penc, table = _pair()
    x = edge_points(384, seed=5)
    cot = np.random.default_rng(6).normal(size=(x.shape[0], penc.out_dim)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(jenc({"table": t}, jnp.asarray(x))
                                                 * jnp.asarray(cot)))(jnp.asarray(table)))
    out = penc(torch.from_numpy(x))
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), penc.table)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the backward's plain version, from the cotangent alone
    d = lotd_grid_bwd_plain(penc.total_params, torch.from_numpy(x), penc._grid_meta,
                            torch.from_numpy(cot).T.contiguous(), None).numpy()
    np.testing.assert_allclose(d, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_wrapper_takes_4d_points_on_the_cpu():
    _, penc, _ = _pair()
    x = torch.from_numpy(edge_points(192))
    out = torch.empty(penc.out_dim, 192)
    lotd_grid(penc.table.detach(), x, penc._grid_meta, out)
    with torch.no_grad():
        np.testing.assert_array_equal(out.T.numpy(), penc(x).numpy())
