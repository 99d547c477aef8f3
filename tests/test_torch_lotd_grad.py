"""Port parity: gradients of the LoTD encoding into its table, the plain
PyTorch versions under autograd against ``jax.grad`` on the CPU. The CUDA
backward kernels are held to autograd of these plain versions in
test_torch_kernels_cuda.py.

The loss is ``sum(c1 * feats) + sum(c2 * jac)`` on a plan with two dense, two
stacked-CP and two hash levels, with points on CP knots, on cell faces and at
0 and 1; ``c1`` alone, ``c2`` alone, and both.

Tolerances. Dense and hash levels: rtol 1e-5 / atol 1e-5 times the level's
largest gradient (only the order of the scatter-add differs). CP levels:
2**-8 times the level's largest gradient. JAX rounds the stacked lines to
bf16 before each tent matmul, so its cotangent of the lines comes back
rounded to bf16 as well (one rounding per matmul, six matmuls, then summed in
float32); the port rounds the lines inside its function and keeps the
gradient in float32, which is the more exact sum. The difference measured
here is 2.7e-3 of the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_torch.fields.encodings import lotd
from test_torch_lotd import SMALL, _pair, _points

torch.set_num_threads(1)

N = 512


def _inputs(penc):
    x = _points(N, penc.cp_rmax)
    # points on the faces of dense/hash cells (x * res an integer), first and
    # last cell included
    for res in (8, 12, 42, 64):
        x[100 + res % 7::37, res % 3] = np.float32(np.arange(len(x[100 + res % 7::37])) % (res + 1)) \
            / np.float32(res)
    rng = np.random.default_rng(5)
    c1 = rng.normal(size=(N, penc.out_dim)).astype(np.float32)
    c2 = rng.normal(size=(N, penc.out_dim, 3)).astype(np.float32)
    return x, c1, c2


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


@pytest.mark.parametrize("which", ["c1", "c2", "both"])
def test_table_gradient_matches_jax(which):
    jenc, penc, table = _pair()
    x, c1, c2 = _inputs(penc)
    c1 = None if which == "c2" else c1
    c2 = None if which == "c1" else c2

    def loss(tbl):
        h, j = jenc.with_jacobian({"table": tbl}, jnp.asarray(x))
        return (0.0 if c1 is None else jnp.sum(c1 * h)) + \
            (0.0 if c2 is None else jnp.sum(c2 * j))

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    got = _port_grad(penc, x, c1, c2)
    assert np.isfinite(got).all()
    for s in penc.specs:
        seg = slice(s.offset, s.offset + s.size * s.n_feats)
        scale = np.abs(want[seg]).max()
        assert scale > 0
        if s.typ == "cp":
            np.testing.assert_allclose(got[seg], want[seg], rtol=0, atol=2.0 ** -8 * scale,
                                       err_msg=f"cp level {s.res}")
        else:
            np.testing.assert_allclose(got[seg], want[seg], rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=f"{s.typ} level {s.res}")


def test_jax_rounds_its_line_gradient_to_bf16():
    """The finding behind the CP tolerance: every entry of JAX's cotangent of
    the stacked lines from one tent matmul is a bf16 number."""
    jenc, penc, table = _pair()
    x, c1, _ = _inputs(penc)
    stacked = jenc._cp_stacked_lines(jnp.asarray(table))
    pos = jnp.clip(jnp.asarray(x), 0.0, 1.0).T
    rows = penc._cp_rows.long().numpy()

    def loss(st):        # only axis 0's feature matmul sees st
        st = jnp.concatenate([st[:1], jax.lax.stop_gradient(st[1:])], 0)
        return jnp.sum(jenc._cp_stacked_features(st, pos) * c1[:, rows].T)

    g = torch.from_numpy(np.array(jax.grad(loss)(stacked)))[0]
    assert float(g.abs().max()) > 0
    assert torch.equal(g, g.to(torch.bfloat16).float())


def test_line_gradient_is_not_rounded_in_the_port():
    _, penc, _ = _pair()
    x, c1, c2 = _inputs(penc)
    lines = penc.cp_stacked_lines().detach().requires_grad_(True)
    h, j = penc.with_jacobian(torch.from_numpy(x),
                              lotd.CpLines(lines, lines.detach().to(torch.bfloat16)))
    ((torch.from_numpy(c1) * h).sum() + (torch.from_numpy(c2) * j).sum()).backward()
    g = lines.grad
    assert g.dtype == torch.float32 and not torch.equal(g, g.to(torch.bfloat16).float())
    # and it is the gradient at the rounded lines, summed in float32
    d_out = torch.from_numpy(c1).T.contiguous()
    d_jac = torch.from_numpy(c2).permute(2, 1, 0).contiguous()
    want = lotd.lotd_cp_stacked_bwd(lines.detach().to(torch.bfloat16), torch.from_numpy(x),
                                    penc._cp_rows, d_out, d_jac)
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("which", ["c1", "c2", "both"])
def test_backward_wrappers_sum_to_the_table_gradient(which):
    """K1's and K3's backward wrappers (their plain versions here), chained
    through the line resampling, give the gradient autograd gives."""
    _, penc, _ = _pair()
    x, c1, c2 = _inputs(penc)
    d_out = None if which == "c2" else torch.from_numpy(c1).T.contiguous()
    d_jac = None if which == "c1" else torch.from_numpy(c2).permute(2, 1, 0).contiguous()
    want = _port_grad(penc, x, None if which == "c2" else c1, None if which == "c1" else c2)
    xt = torch.from_numpy(x)
    lines = penc.cp_stacked_lines()
    d_lines = lotd.lotd_cp_stacked_bwd(lines.detach().to(torch.bfloat16), xt, penc._cp_rows,
                                       d_out, d_jac)
    got = torch.autograd.grad(lines, penc.table, d_lines)[0] + \
        lotd.lotd_grid_bwd(penc.total_params, xt, penc._grid_meta, d_out, d_jac)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_no_gradient_in_the_proposal_ladder_mode():
    _, penc, _ = _pair()
    with torch.no_grad():
        h = penc(torch.from_numpy(_points(64, penc.cp_rmax)))
    assert not h.requires_grad


def test_full_width_plan_has_no_dense_level_but_the_small_one_has():
    assert [t for _, _, t in lotd.tpu_mixed_levels(
        8, base_res=16, max_res=256, n_feats=2, n_hash_levels=2, cp_max_res=128)] == \
        ["cp"] * 6 + ["hash"] * 2
    assert "dense" in [s.typ for s in lotd.make_lotd(SMALL).specs]
