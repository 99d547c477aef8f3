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
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.encodings.lotd import make_lotd as jax_make_lotd
from neuralsim_tpu.fields.encodings.lotd import ngp_levels as jax_ngp_levels
from neuralsim_torch.fields.encodings.lotd import (grid_bwd_plan, grid_corner_rows,
                                                   grid_fwd_plan, lotd_grid,
                                                   lotd_grid_bwd_plain, make_lotd, ngp_levels)

torch.set_num_threads(1)

SMALL4 = {"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2, "log2_hashmap_size": 10}
# the distant field of configs/waymo_streetsurf.yaml (the plan only: its table is 2.5 M floats)
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
    level interleaved into the scratch) and its backward sums none there."""
    enc = make_lotd(STREETSURF4, input_dim=4)
    assert [s.typ for s in enc.specs] == ["dense"] + ["hash"] * 9
    assert enc.specs[0].size == 17 ** 4 and all(s.size == 2 ** 17 for s in enc.specs[1:])
    assert enc.grid_fwd_plan.stage_mask == 0 and enc.grid_fwd_plan.n_shared == 0
    assert enc.grid_fwd_plan.n_inter == sum((s.size * 2 + 3) // 4 * 4 for s in enc.specs)
    assert enc.grid_bwd_plan == (0, 0) and enc.grid_bwd_plan.at(262_144) == (0, 0)
    assert grid_fwd_plan(enc._grid_meta.tolist()) == enc.grid_fwd_plan
    assert grid_bwd_plan(enc._grid_meta.tolist()) == enc.grid_bwd_plan


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
