"""Port parity for the permutohedral-lattice encoding (K9's plain version):
``neuralsim_torch.fields.encodings.permuto`` against
``neuralsim_tpu.fields.encodings.permuto`` on the CPU.

The simplex (vertex keys, hashed rows, barycentric weights and their
derivative) is compared with JAX's ``_simplex`` and ``_hash_keys`` run op by
op, at d = 3, 4, 7 and 11, on seeded points spread over a wide lattice range
and on points placed on lattice faces: the keys and rows must be identical
(share of differing rows 0) and the weights bit-equal. The plain version is
the JAX math op for op; jitted, XLA reorders a few of these float operations
and puts about 2.5e-5 of such points on another vertex at d >= 7 (measured
while writing this port), so the exact comparison is with the eager ops.

The encoding (features, the jacobian, and the gradients of the table and of
the inputs from cotangents of both) is compared with the JAX encoding's
``__call__``, ``with_jacobian`` and ``jax.grad`` at 3 levels and a
2^10-2^12 table, d = 4 and 11, with points outside [0, 1] and on its edges
(the clip's half gradient). Tolerances, each relative to the largest entry:
against JAX op by op, features, jacobian and gradients within 1e-6
(measured: equal). Against jitted JAX, which puts a point here and there on
another simplex (1 of 1,024 at d = 11, a point on the clip's edge, where
ties decide the rank; at most 0.5% allowed), those points are left out (the
comparison with the eager ops holds them) and their cotangents zeroed; on
the rest: the jacobian within 1e-6 (measured
9e-8), the features within 5e-5 (measured 1.9e-5 at d = 11: XLA fuses
``(elevated - rem0) / (d+1)`` and the one-hot sum, and the weights move by
an ulp of the elevated coordinate over d + 1), the table's gradient within
5e-5 as well (the same weights scale the cotangents: measured 1.0e-5 from
the features' cotangent alone, 1.9e-7 with the jacobian's), the inputs'
gradient within 1e-5 (measured 1.3e-7).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.encodings.permuto import PermutoEncoding as JaxPermuto
from neuralsim_tpu.fields.encodings.permuto import _hash_keys as jax_hash_keys
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.fields.encodings import permuto

torch.set_num_threads(1)

N = 1024
EAGER_REL, JIT_FEAT_REL, JIT_JAC_REL, JIT_GRAD_REL = 1e-6, 5e-5, 1e-6, 1e-5
OTHER_SIMPLEX_MAX = 0.005


def _lattice_points(d, seed):
    """[d, N] scaled positions: uniform over [-40, 260), and a quarter on the
    faces of the lattice (coordinates that are multiples of 1/4)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((d, N)) * 300.0 - 40.0
    pos[:, ::4] = np.round(pos[:, ::4] * 4.0) / 4.0
    return pos.astype(np.float32)


@pytest.mark.parametrize("d", [3, 4, 7, 11])
def test_simplex_matches_jax_exactly(d):
    pos = _lattice_points(d, d)
    jkeys, jbary, jdbary = JaxPermuto(d, n_levels=1)._simplex(jnp.asarray(pos), jac_dims=3)
    keys, bary, dbary = permuto.simplex(torch.from_numpy(pos), 3)
    T = 2 ** 12
    differ = np.mean([np.any(np.asarray(jax_hash_keys(jkeys[k], T))
                             != permuto.hash_keys(keys[k], T).numpy())
                      for k in range(d + 1)])
    assert differ == 0.0
    for k in range(d + 1):
        np.testing.assert_array_equal(keys[k].numpy(), np.asarray(jkeys[k]))
    np.testing.assert_array_equal(bary.numpy(), np.asarray(jbary))
    np.testing.assert_array_equal(dbary.numpy(), np.asarray(jdbary))
    # negative keys occur, so the uint32 wrap of the hash is exercised
    assert min(int(k.min()) for k in keys) < 0


def test_hash_wraps_like_uint32():
    keys = torch.tensor([[-1, 2 ** 31 - 1, -2 ** 31, 7], [5, -3, 123456789, -987654321],
                         [0, 1, -1, 2 ** 30]], dtype=torch.int32)
    got = permuto.hash_keys(keys, 2 ** 17).numpy()
    want = np.asarray(jax_hash_keys(jnp.asarray(keys.numpy()), 2 ** 17))
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _pair(d, log2):
    jenc = JaxPermuto(d, n_levels=3, base_res=4.0, max_res=32.0, log2_hashmap_size=log2)
    rng = np.random.default_rng(d + log2)
    table = rng.normal(0.0, 1.0, jenc.total_params).astype(np.float32)
    penc = permuto.PermutoEncoding(d, n_levels=3, base_res=4.0, max_res=32.0,
                                   log2_hashmap_size=log2)
    load_jax_params(penc, {"table": table})
    x = rng.random((N, d)).astype(np.float32)
    x[:40] = rng.random((40, d)) * 1.4 - 0.2           # outside [0, 1]: clipped
    x[40:60, 0], x[60:80, 1] = 0.0, 1.0                # on the clip's edges
    c1 = rng.normal(size=(N, penc.out_dim)).astype(np.float32)
    c2 = rng.normal(size=(N, penc.out_dim, 3)).astype(np.float32)
    return jenc, penc, table, x, c1, c2


def _rel(got, want):
    return float(np.abs(got - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@functools.lru_cache(maxsize=None)
def _other_simplex(d, log2):
    """The points on which jitted JAX picks another simplex than the plain
    version (its jacobian off by more than 1e-3 of the largest entry), and
    jitted JAX's features and jacobian."""
    jenc, penc, table, x, _, _ = _pair(d, log2)
    wh, wj = jax.jit(jenc.with_jacobian)({"table": jnp.asarray(table)}, jnp.asarray(x))
    with torch.no_grad():
        pj = penc.with_jacobian(torch.from_numpy(x))[1].numpy()
    e = np.abs(pj - np.asarray(wj)).reshape(len(x), -1).max(-1)
    return e > 1e-3 * np.abs(np.asarray(wj)).max(), wh, wj


@pytest.mark.parametrize("d,log2", [(4, 10), (11, 12)])
def test_features_and_jacobian_match_jax(d, log2):
    jenc, penc, table, x, _, _ = _pair(d, log2)
    params = {"table": jnp.asarray(table)}
    with torch.no_grad():
        h = penc(torch.from_numpy(x)).numpy()
        ph, pj = (t.numpy() for t in penc.with_jacobian(torch.from_numpy(x)))
    assert h.shape == (N, penc.out_dim) and pj.shape == (N, penc.out_dim, 3)
    with jax.disable_jit():
        eh, ej = jenc.with_jacobian(params, jnp.asarray(x))
    assert _rel(ph, eh) <= EAGER_REL and _rel(pj, ej) <= EAGER_REL
    other, wh, wj = _other_simplex(d, log2)
    assert other.mean() <= OTHER_SIMPLEX_MAX
    want = jax.jit(jenc.__call__)(params, jnp.asarray(x))
    keep = ~other
    assert _rel(h[keep], np.asarray(want)[keep]) <= JIT_FEAT_REL
    assert _rel(ph[keep], np.asarray(wh)[keep]) <= JIT_FEAT_REL
    assert _rel(pj[keep], np.asarray(wj)[keep]) <= JIT_JAC_REL


def _jax_loss(jenc):
    """sum(features * c1) + sum(jacobian * c2): a zero cotangent stands for
    an absent one (the gradients are linear in the cotangents)."""
    def loss(t, xx, c1, c2):
        h, j = jenc.with_jacobian({"table": t}, xx)
        return jnp.sum(h * c1) + jnp.sum(j * c2)
    return loss


@functools.lru_cache(maxsize=None)
def _jax_grad(d, log2):
    """jitted JAX d table and d x at (table, x, c1, c2): one compile a width."""
    return jax.jit(jax.grad(_jax_loss(_pair(d, log2)[0]), argnums=(0, 1)))


def _port_grads(penc, x, c1, c2):
    xt = torch.from_numpy(x).requires_grad_(True)
    h, j = penc.with_jacobian(xt)
    total = h.new_zeros(())
    if c1 is not None:
        total = total + (h * torch.from_numpy(c1)).sum()
    if c2 is not None:
        total = total + (j * torch.from_numpy(c2)).sum()
    grads = torch.autograd.grad(total, [penc.table, xt], allow_unused=True)
    return [np.zeros(x.shape, np.float32) if g is None else g.numpy() for g in grads]


@pytest.mark.parametrize("d,log2", [(4, 10), (11, 12)])
@pytest.mark.parametrize("which", ["feats", "jac", "both"])
def test_gradients_match_jax(d, log2, which):
    """d table and d x from cotangents of the features, the jacobian or both,
    through the module under autograd and through the backward wrapper."""
    jenc, penc, table, x, c1, c2 = _pair(d, log2)
    other = _other_simplex(d, log2)[0]
    assert other.mean() <= OTHER_SIMPLEX_MAX
    c1, c2 = np.where(other[:, None], 0.0, c1), np.where(other[:, None, None], 0.0, c2)
    c1 = None if which == "jac" else c1
    c2 = None if which == "feats" else c2
    wt, wx = _jax_grad(d, log2)(jnp.asarray(table), jnp.asarray(x),
                                *(np.zeros(shape, np.float32) if c is None else c
                                  for c, shape in ((c1, (N, penc.out_dim)),
                                                   (c2, (N, penc.out_dim, 3)))))
    gt, gx = _port_grads(penc, x, c1, c2)
    assert _rel(gt, wt) <= JIT_FEAT_REL
    if which == "jac":          # the jacobian is piecewise constant in x
        assert not np.abs(np.asarray(wx)).max() and not np.abs(gx).max()
    else:
        assert _rel(gx, wx) <= JIT_GRAD_REL

    # the backward wrapper (K9's plain backward on the CPU): point-major
    # cotangents, the clipped inputs
    from neuralsim_torch.fields.neus import clip01
    x01 = clip01(torch.from_numpy(x))
    d_out = None if c1 is None else torch.from_numpy(c1)
    d_jac = None if c2 is None else torch.from_numpy(c2)
    bt, bx = permuto.permuto_bwd(penc.table.detach(), x01, penc._res, penc._meta,
                                 penc.table_size, d_out, d_jac)
    assert _rel(bt.numpy(), wt) <= JIT_FEAT_REL
    inside = ((x > 0) & (x < 1)).all(-1)
    if which != "jac":
        assert _rel(bx.numpy()[inside], np.asarray(wx)[inside]) <= JIT_GRAD_REL


def test_gradients_match_jax_op_by_op():
    jenc, penc, table, x, c1, c2 = _pair(11, 12)
    with jax.disable_jit():
        wt, wx = jax.grad(_jax_loss(jenc), argnums=(0, 1))(jnp.asarray(table),
                                                           jnp.asarray(x), c1, c2)
    gt, gx = _port_grads(penc, x, c1, c2)
    assert _rel(gt, wt) <= EAGER_REL and _rel(gx, wx) <= EAGER_REL


def test_layout_init_and_what_is_not_ported():
    jenc = JaxPermuto(11, n_levels=12, base_res=4.0, max_res=256.0, log2_hashmap_size=17)
    penc = permuto.PermutoEncoding(11, n_levels=12, base_res=4.0, max_res=256.0,
                                   log2_hashmap_size=17)
    assert penc.out_dim == jenc.out_dim == 24 and penc.total_params == jenc.total_params \
        == 12 * 2 * 2 ** 17
    assert penc._res.tolist() == [np.float32(r) for r, _ in jenc.levels]
    assert [int(m[0]) for m in penc._meta] == jenc.offsets
    penc.reset_parameters(torch.Generator().manual_seed(0))
    t = penc.table.detach()
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 5e-5
    x = torch.rand(4, 11)
    with pytest.raises(NotImplementedError, match="bidx"):
        penc(x, bidx=torch.zeros(4, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="anneal"):
        permuto.PermutoEncoding(11, anneal_cfg={"stop_it": 10})
    assert penc.kernel_lines() is None


def test_interleave_round_trip():
    """The kernels' table layout ([T, F] per level) and back, with levels of
    F 1, 3 and 4 beside F 2."""
    enc = permuto.PermutoEncoding(4, levels=[(4.0, 2), (8.0, 1), (16.0, 4), (32.0, 3)],
                                  log2_hashmap_size=5)
    T = enc.table_size
    table = torch.arange(enc.total_params, dtype=torch.float32)
    inter = permuto.interleave_plain(table, enc._meta, T)
    for off, nf, _ in enc._meta.tolist():
        slab = inter[off:off + nf * T].view(T, nf)
        assert torch.equal(slab, table[off:off + nf * T].view(nf, T).T)
    assert torch.equal(permuto.deinterleave_plain(inter, enc._meta, T), table)


@functools.lru_cache(maxsize=None)
def _plain_pair(d):
    jenc = JaxPermuto(d, n_levels=3, base_res=4.0, max_res=32.0, log2_hashmap_size=10)
    penc = permuto.PermutoEncoding(d, n_levels=3, base_res=4.0, max_res=32.0,
                                   log2_hashmap_size=10)
    rng = np.random.default_rng(40 + d)
    table = rng.normal(0.0, 1.0, jenc.total_params).astype(np.float32)
    x = rng.random((N, d)).astype(np.float32) * 0.98 + 0.01   # inside (0, 1): no clip
    c1 = rng.normal(size=(N, penc.out_dim)).astype(np.float32)
    c2 = rng.normal(size=(N, penc.out_dim, 3)).astype(np.float32)
    return jenc, penc, table, x, c1, c2


@pytest.mark.parametrize("d", [3, 11])
def test_plain_k9_point_major_matches_jax(d):
    """K9's plain version and its backward, in the point-major layout
    (features [N, C], jacobian [N, C, 3] and cotangents alike), against the
    JAX encoding op by op: features, jacobian, and the table's and inputs'
    gradients from both cotangents."""
    jenc, penc, table, x, c1, c2 = _plain_pair(d)
    a = (torch.from_numpy(table), torch.from_numpy(x), penc._res, penc._meta, penc.table_size)
    out, jac = permuto.permuto_plain(*a, True)
    assert out.shape == (N, penc.out_dim) and jac.shape == (N, penc.out_dim, 3)
    with jax.disable_jit():
        eh, ej = jenc.with_jacobian({"table": jnp.asarray(table)}, jnp.asarray(x))
        wt, wx = jax.grad(_jax_loss(jenc), argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x),
                                                           c1, c2)
    assert _rel(out.numpy(), eh) <= EAGER_REL and _rel(jac.numpy(), ej) <= EAGER_REL
    gt, gx = permuto.permuto_bwd_plain(*a, torch.from_numpy(c1), torch.from_numpy(c2))
    assert _rel(gt.numpy(), wt) <= EAGER_REL and _rel(gx.numpy(), wx) <= EAGER_REL
