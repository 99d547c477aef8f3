"""Port parity: the per-level CP path of the LoTD encoding (kernel K2, a
single CP level or ``NEURALSIM_CP_STACKED=0``), plain PyTorch versions
against the JAX package on the CPU, and the refusal of the unported
``NEURALSIM_CP_JAC_F32`` knob. The CUDA kernels are held to
these plain versions in test_torch_kernels_cuda.py.

Plans: a non-nested CP ladder (R 16, 25, 40: R_max - 1 = 39 is no multiple of
15 or 24, so the stacked path would compute another function) beside a dense
level, and a plan with a single CP level beside a dense and a hash level.

Tolerances. Features and jacobians: rtol 1e-5 / atol 1e-5, K1's (both
packages round the lines and tent weights to bf16, only f32 sums may differ).
Table gradient: dense and hash levels 1e-5 of the level's largest entry. CP
levels: JAX rounds its cotangent of a level's bf16 lines to bf16, the port
sums it in float32 (as for K1, test_torch_lotd_grad.py). On the per-level
path an axis's lines feed two bf16 matmuls (features and slopes), whose bf16
cotangents JAX adds in bf16: three roundings of up to 2**-9 each, so 2**-7
of the largest entry (4.1e-3 measured here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.fields.encodings import lotd
from neuralsim_tpu.fields.encodings.lotd import LoTDEncoding as JaxLoTD
from test_torch_lotd import _points

torch.set_num_threads(1)

NON_NESTED = [(4, 2, "dense"), (16, 4, "cp"), (25, 4, "cp"), (40, 4, "cp")]
SINGLE_CP = [(4, 2, "dense"), (20, 4, "cp"), (24, 2, "hash")]
PLANS = {"non-nested ladder": NON_NESTED, "single CP level": SINGLE_CP}
TOL = dict(rtol=1e-5, atol=1e-5)
N = 512


@pytest.fixture(autouse=True)
def _no_cp_knobs(monkeypatch):
    monkeypatch.delenv("NEURALSIM_CP_STACKED", raising=False)
    monkeypatch.delenv("NEURALSIM_CP_JAC_F32", raising=False)


def _pair(levels, seed=0, cp_stacked=False):
    jenc = JaxLoTD(levels, log2_hashmap_size=10, cp_stacked=cp_stacked)
    table = np.asarray(jenc.init(jax.random.PRNGKey(seed))["table"])
    rng = np.random.default_rng(seed)
    table = (table + rng.normal(0.0, 0.3, table.shape)).astype(np.float32)
    penc = lotd.LoTDEncoding(levels, log2_hashmap_size=10, cp_stacked=cp_stacked)
    load_jax_params(penc, {"table": table})
    return jenc, penc, table


def _inputs(penc, seed=1):
    x = _points(N, 40, seed)
    # CP knots of every level (pos exactly integer) on axis 2
    for k, R in enumerate((16, 20, 25)):
        xs = np.arange(R, dtype=np.float32) / np.float32(R - 1)
        xs = xs[xs * np.float32(R - 1) == np.arange(R, dtype=np.float32)]
        x[300 + 30 * k:300 + 30 * k + len(xs[:30]), 2] = xs[:30]
    rng = np.random.default_rng(seed + 10)
    c1 = rng.normal(size=(N, penc.out_dim)).astype(np.float32)
    c2 = rng.normal(size=(N, penc.out_dim, 3)).astype(np.float32)
    return x, c1, c2


@pytest.mark.parametrize("plan", PLANS)
def test_per_level_features_and_jacobian_match_jax(plan):
    jenc, penc, table = _pair(PLANS[plan])
    assert not jenc.cp_stacked and not penc.cp_stacked and penc.kernel_lines() is None
    x, _, _ = _inputs(penc)
    jp = {"table": jnp.asarray(table)}
    want_f, want_j = jenc.with_jacobian(jp, jnp.asarray(x))
    got_f, got_j = penc.with_jacobian(torch.from_numpy(x))
    np.testing.assert_allclose(got_f.detach().numpy(), np.asarray(want_f), **TOL)
    np.testing.assert_allclose(got_j.detach().numpy(), np.asarray(want_j), **TOL)
    np.testing.assert_allclose(penc(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jenc(jp, jnp.asarray(x))), **TOL)


def test_k2_plain_matches_cp_level_features_level_by_level():
    """K2's plain version writes each level's rows, JAX's _cp_level_features
    per level, into a wider buffer; tent' is 0 at an exact knot."""
    jenc, penc, table = _pair(NON_NESTED, seed=2)
    x, _, _ = _inputs(penc, seed=3)
    pos = jnp.clip(jnp.asarray(x), 0.0, 1.0).T
    meta = penc._cp_meta.clone()
    meta[:, 3] += 1                                       # one row of margin
    C = penc.out_dim + 2
    out = torch.full((C, N), float("nan"))
    jac = torch.full((3, C, N), float("nan"))
    lotd.lotd_cp_level(torch.from_numpy(table), torch.from_numpy(x), meta, out, jac)
    for spec, (R, _, F, row) in zip([s for s in jenc.specs if s.typ == "cp"], meta.tolist()):
        f, j = jenc._cp_level_features(jnp.asarray(table), pos, spec, with_jac=True)
        np.testing.assert_allclose(out[row:row + F].numpy(), np.asarray(f), **TOL)
        np.testing.assert_allclose(jac[:, row:row + F].numpy(), np.asarray(j), **TOL)
        knot = np.clip(x[:, 2], 0, 1) * np.float32(R - 1)
        at_knot = knot == np.floor(knot)
        assert at_knot.sum() >= 10 and np.all(jac[2, row:row + F].numpy()[:, at_knot] == 0.0)
    assert out[0].isnan().all() and out[-1].isnan().all()


def _port_grad(penc, x, c1, c2):
    penc.table.grad = None
    h, j = penc.with_jacobian(torch.from_numpy(x))
    loss = h.new_zeros(())
    if c1 is not None:
        loss = loss + (torch.from_numpy(c1) * h).sum()
    if c2 is not None:
        loss = loss + (torch.from_numpy(c2) * j).sum()
    loss.backward()
    return penc.table.grad.numpy().copy()


def _check_table_grad(specs, got, want, cp_rel=2.0 ** -7):
    assert np.isfinite(got).all()
    for s in specs:
        seg = slice(s.offset, s.offset + s.size * s.n_feats)
        scale = np.abs(want[seg]).max()
        assert scale > 0
        atol = (cp_rel if s.typ == "cp" else 1e-5) * scale
        np.testing.assert_allclose(got[seg], want[seg], rtol=0 if s.typ == "cp" else 1e-5,
                                   atol=atol, err_msg=f"{s.typ} level {s.res}")


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("which", ["c1", "c2", "both"])
def test_per_level_table_gradient_matches_jax(plan, which):
    jenc, penc, table = _pair(PLANS[plan], seed=4)
    x, c1, c2 = _inputs(penc, seed=5)
    c1 = None if which == "c2" else c1
    c2 = None if which == "c1" else c2

    def loss(tbl):
        h, j = jenc.with_jacobian({"table": tbl}, jnp.asarray(x))
        return (0.0 if c1 is None else jnp.sum(c1 * h)) + \
            (0.0 if c2 is None else jnp.sum(c2 * j))

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    _check_table_grad(penc.specs, _port_grad(penc, x, c1, c2), want)


@pytest.mark.parametrize("which", ["c1", "c2", "both"])
def test_k2_backward_wrapper_is_the_autograd_gradient(which):
    """K2's backward wrapper (its plain version here), added to K3's, gives
    the table gradient autograd gives; outside the CP segments it adds 0."""
    _, penc, table = _pair(SINGLE_CP, seed=6)
    x, c1, c2 = _inputs(penc, seed=7)
    d_out = None if which == "c2" else torch.from_numpy(c1).T.contiguous()
    d_jac = None if which == "c1" else torch.from_numpy(c2).permute(2, 1, 0).contiguous()
    want = _port_grad(penc, x, None if which == "c2" else c1, None if which == "c1" else c2)
    xt, tt = torch.from_numpy(x), torch.from_numpy(table)
    alone = lotd.lotd_cp_level_bwd(tt, xt, penc._cp_meta, d_out, d_jac)
    cp = penc.specs[1]
    outside = torch.ones(table.shape, dtype=torch.bool)
    outside[cp.offset:cp.offset + cp.size * cp.n_feats] = False
    assert torch.all(alone[outside] == 0) and float(alone.abs().max()) > 0
    d_table = lotd.lotd_grid_bwd(penc.total_params, xt, penc._grid_meta, d_out, d_jac)
    got = lotd.lotd_cp_level_bwd(tt, xt, penc._cp_meta, d_out, d_jac, d_table)
    assert got is d_table
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("env,levels,stacked", [
    (None, NON_NESTED, True), ("1", NON_NESTED, True), ("0", NON_NESTED, False),
    ("true", NON_NESTED, False), (None, SINGLE_CP, False), ("1", SINGLE_CP, False)])
def test_cp_stacked_environment_matches_jax(monkeypatch, env, levels, stacked):
    """NEURALSIM_CP_STACKED, read when the encoding is built: unset keeps the
    argument, "1" stacks, any other value takes the per-level path; a single
    CP level is always per-level."""
    if env is not None:
        monkeypatch.setenv("NEURALSIM_CP_STACKED", env)
    jenc = JaxLoTD(levels, log2_hashmap_size=10)
    penc = lotd.LoTDEncoding(levels, log2_hashmap_size=10)
    assert jenc.cp_stacked == penc.cp_stacked == stacked
    assert (penc.kernel_lines() is not None) == stacked
    assert penc._cp_meta.shape[0] == (0 if stacked else
                                      sum(1 for _, _, t in levels if t == "cp"))
    # the argument is overridden where the variable is set
    assert lotd.LoTDEncoding(levels, log2_hashmap_size=10, cp_stacked=False).cp_stacked == \
        (stacked if env is not None else False)


def test_per_level_and_stacked_differ_on_a_non_nested_ladder():
    """Why the flagship's setting needs its own kernel: on this ladder the
    stacked lerp computes another function, by far more than rounding."""
    jenc, penc, table = _pair(NON_NESTED, seed=8)
    stacked = lotd.LoTDEncoding(NON_NESTED, log2_hashmap_size=10, cp_stacked=True)
    load_jax_params(stacked, {"table": table})
    x = torch.from_numpy(_inputs(penc, seed=9)[0])
    with torch.no_grad():
        d = (penc(x) - stacked(x)).abs().max()
    assert float(d) > 1e-2


@pytest.mark.parametrize("plan", ["stacked", "per-level"])
def test_cp_jac_f32_refused_only_where_jax_reads_it(monkeypatch, plan):
    """NEURALSIM_CP_JAC_F32=1 (float32 lines for the stacked jacobian, JAX
    lotd.py:379-382) is not ported: the stacked jacobian raises with the
    knob's name. The stacked features, and the per-level path, which JAX
    computes the same under the knob, still match JAX."""
    stacked = plan == "stacked"
    jenc, penc, table = _pair(NON_NESTED, seed=10, cp_stacked=stacked)
    assert penc.cp_stacked == stacked
    x = _inputs(penc, seed=11)[0]
    jp = {"table": jnp.asarray(table)}
    monkeypatch.setenv("NEURALSIM_CP_JAC_F32", "1")
    with torch.no_grad():
        got_f = penc(torch.from_numpy(x))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(jenc(jp, jnp.asarray(x))), **TOL)
    if stacked:
        with pytest.raises(NotImplementedError, match="NEURALSIM_CP_JAC_F32"):
            penc.with_jacobian(torch.from_numpy(x))
    else:
        _, got_j = penc.with_jacobian(torch.from_numpy(x))
        _, want_j = jenc.with_jacobian(jp, jnp.asarray(x))
        np.testing.assert_allclose(got_j.detach().numpy(), np.asarray(want_j), **TOL)
