"""The stacked CP lines in both forms (K14's forward) and the encoding's
lines cache, on the CPU.

K14 writes the float32 lines, which autograd differentiates, and the bf16
lines that K1 reads, in one launch; its plain version returns both, the bf16
one the float32 one cast (exact). Without grad the encoding keeps the lines
until its table changes (``LinesCache``, keyed as ``GridScratch``): a second
call on an unchanged table makes nothing, a ``copy_`` into the table, the
bridge's load and a ``ModelAdam`` step make them anew, a call with grad
enabled always makes them anew and never stores them, and no call with grad
enabled gets the kept ones.

The card's autograd wiring (``_CpLinesOnCard`` feeding ``_EncodeOnCard``,
whose wrappers take their plain versions for CPU tensors) is run here too:
the bf16 lines carry no gradient, the lines' gradient arrives in float32,
unrounded, and the table's gradient equals the CPU path's (plain autograd;
the same sums, 1e-6 of the largest entry) and JAX's (the tolerance of
test_torch_lotd_grad.py: 2**-8 of a CP level's largest entry, where JAX
rounds its line gradient to bf16; 1e-5 elsewhere). The JAX gradient is
computed once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.fields.encodings import lotd
from neuralsim_torch.training.optimizers import ModelAdam
from test_torch_lotd import _pair, _points

torch.set_num_threads(1)

N = 384


@pytest.fixture()
def counted(monkeypatch):
    """The plain K14 calls (the CPU path's lines) made while the test runs."""
    calls = []
    plain = lotd.lotd_cp_lines_plain

    def call(table, plan):
        calls.append(torch.is_grad_enabled())
        return plain(table, plan)

    monkeypatch.setattr(lotd, "lotd_cp_lines_plain", call)
    return calls


@pytest.fixture(scope="module")
def grads():
    """x, cotangents, and JAX's table gradient of sum(c1 h) + sum(c2 jac)."""
    jenc, penc, table = _pair()
    x = _points(N, penc.cp_rmax, seed=3)
    rng = np.random.default_rng(4)
    out_dim = penc.out_dim
    c1 = rng.normal(size=(N, out_dim)).astype(np.float32)
    c2 = rng.normal(size=(N, out_dim, 3)).astype(np.float32)

    def loss(tbl):
        h, j = jenc.with_jacobian({"table": tbl}, jnp.asarray(x))
        return jnp.sum(c1 * h) + jnp.sum(c2 * j)

    return x, c1, c2, np.asarray(jax.grad(loss)(jnp.asarray(table)))


def test_plain_lines_in_both_forms():
    _, penc, _ = _pair()
    plan = penc.cp_lines_plan()
    assert plan.lo.dtype == torch.int32
    f32, bf16 = lotd.lotd_cp_lines(penc.table.detach(), plan)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16)) and not bf16.requires_grad
    lines = penc.kernel_lines()
    assert isinstance(lines, lotd.CpLines) and lines.f32.requires_grad
    assert torch.equal(lines.f32, f32) and torch.equal(lines.bf16, bf16)
    assert not lines.bf16.requires_grad


def test_lines_kept_without_grad_on_an_unchanged_table(counted):
    _, penc, _ = _pair()
    with torch.no_grad():
        a = penc.kernel_lines()
        b = penc.kernel_lines()
        h = penc(torch.from_numpy(_points(64, penc.cp_rmax)))       # takes them itself
    assert a is b and len(counted) == 1 and not a.f32.requires_grad
    assert penc.lines_cache.lines is a and h.shape == (64, penc.out_dim)


@pytest.mark.parametrize("how", ["copy_", "bridge", "ModelAdam step"])
def test_lines_made_anew_after_the_table_changes(counted, how):
    _, penc, table = _pair()
    with torch.no_grad():
        a = penc.kernel_lines()
    if how == "copy_":
        with torch.no_grad():
            penc.table.copy_(torch.from_numpy(table) * 0.5)
    elif how == "bridge":
        load_jax_params(penc, {"table": table * 0.5})
    else:
        opt = ModelAdam([penc.table], {"lr": 0.1})
        opt.step([torch.ones_like(penc.table)])
    with torch.no_grad():
        b = penc.kernel_lines()
        c = penc.kernel_lines()
    assert b is not a and c is b and len(counted) == 2
    want = lotd.lotd_cp_lines_plain(penc.table.detach(), penc.cp_lines_plan())[0]
    assert torch.equal(b.f32, want) and not torch.equal(a.f32, b.f32)


def test_lines_never_served_or_kept_with_grad(counted):
    _, penc, _ = _pair()
    with torch.no_grad():
        kept = penc.kernel_lines()
    g1, g2 = penc.kernel_lines(), penc.kernel_lines()
    assert g1 is not kept and g2 is not g1 and g1.f32.requires_grad
    assert counted == [False, True, True]
    with torch.no_grad():
        assert penc.kernel_lines() is kept                          # the store kept its own
    assert penc.lines_cache.lines is kept
    with pytest.raises(ValueError, match="not kept"):
        penc.lines_cache.put(penc.table, g1)


def _card_wiring(penc, x):
    """The card path's autograd functions, run on CPU tensors (each wrapper
    takes its plain version): -> (features [N, C], jac [N, C, 3], lines)."""
    xf = torch.from_numpy(x)
    lines = lotd.CpLines(*lotd._CpLinesOnCard.apply(penc.table, penc.cp_lines_plan()))
    out, jac = lotd._EncodeOnCard.apply(
        lines.f32, lines.bf16, penc.table, xf, penc._cp_rows, penc._cp_meta, penc._grid_meta,
        ((penc.grid_fwd_plan, penc.grid_scratch), penc.grid_bwd_plan), penc.out_dim, True)
    return out.T, jac.permute(2, 1, 0), lines


def test_card_wiring_gradient_is_float32_and_matches(grads):
    x, c1, c2, want = grads
    _, penc, _ = _pair()
    h, j, lines = _card_wiring(penc, x)
    assert not lines.bf16.requires_grad and lines.bf16.grad_fn is None
    seen = []
    lines.f32.register_hook(lambda g: seen.append(g))
    penc.table.grad = None
    ((torch.from_numpy(c1) * h).sum() + (torch.from_numpy(c2) * j).sum()).backward()
    got = penc.table.grad.numpy().copy()
    (d_lines,) = seen
    assert d_lines.dtype == torch.float32
    assert not torch.equal(d_lines, d_lines.to(torch.bfloat16).float())     # not rounded
    # the CPU path's gradient (plain autograd through _RoundBf16)
    penc.table.grad = None
    hp, jp = penc.with_jacobian(torch.from_numpy(x))
    ((torch.from_numpy(c1) * hp).sum() + (torch.from_numpy(c2) * jp).sum()).backward()
    cpu = penc.table.grad.numpy()
    assert torch.equal(h, hp.detach()) and torch.equal(j, jp.detach())
    np.testing.assert_allclose(got, cpu, rtol=0, atol=1e-6 * np.abs(cpu).max())
    for s in penc.specs:
        seg = slice(s.offset, s.offset + s.size * s.n_feats)
        scale = np.abs(want[seg]).max()
        tol = dict(rtol=0, atol=2.0 ** -8 * scale) if s.typ == "cp" else \
            dict(rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(got[seg], want[seg], err_msg=f"{s.typ} {s.res}", **tol)
