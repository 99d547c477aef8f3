"""Port parity: the layout that K3's forward kernel reads, against the JAX
package on the CPU.

The kernel reads each dense or hash level as a [size, F] copy: levels that
fit a block's shared memory are staged there, the others interleaved into a
scratch, and a level that fits neither (a plan of another meta) is read from
the table itself (``grid_fwd_plan``, ``grid_fwd_places``,
``grid_interleave_plain`` in neuralsim_torch/fields/encodings/lotd.py).
``lotd_grid_layout_plain`` gathers through those copies exactly as the
kernel places them; here it is held to JAX's ``_level_features`` at
chip_smoke's K3 edge encodings (F 1, 2, 3, 4 and 8, dense and hash levels
in one meta, staged, interleaved and table-read levels) and edge positions
(0, 1, one ulp below 1, -0.25, 1.5 on every axis), under each encoding's
own plan, a plan with no copies and the other encoding's plan. Tolerance:
rtol 1e-5, atol 1e-5 (test_torch_lotd.py's: only the f32 summation order
may differ). The kernel itself is held to these plain versions in
test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from neuralsim_tpu.fields.encodings.lotd import LoTDEncoding as JaxLoTD
from neuralsim_torch.configs import SYNTHETIC_OBJECT, WAYMO_DEMO_MULTI
from neuralsim_torch.fields.conditional import ConditionalLoTDNeuSField
from neuralsim_torch.fields.encodings import lotd

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(i):
    _, levels, log2 = cs.K3_EDGE_ENCODINGS[i]
    table = np.random.default_rng(400 + i).normal(
        size=lotd.LoTDEncoding(levels, log2_hashmap_size=log2).total_params).astype(np.float32)
    return (JaxLoTD(levels, 3, log2_hashmap_size=log2),
            lotd.LoTDEncoding(levels, log2_hashmap_size=log2), table)


def _jax_levels(jenc, table, x):
    """Every level's features [F, N] and jacobian [3, F, N], one jitted call."""
    def run(t, x):
        pos01 = jnp.clip(x, 0.0, 1.0).T
        outs = []
        for spec in jenc.specs:
            pos = pos01 * spec.res
            cell = jnp.minimum(jnp.floor(pos), spec.res - 1)
            outs.append(jenc._level_features(t, cell.astype(jnp.int32), pos - cell, spec,
                                             with_jac=True))
        return outs
    return [(np.asarray(f), np.asarray(j))
            for f, j in jax.jit(run)(jnp.asarray(table), jnp.asarray(x))]


@pytest.mark.parametrize("plan", ["own", "no copies", "other's"])
@pytest.mark.parametrize("i", range(len(cs.K3_EDGE_ENCODINGS)))
def test_layout_plain_matches_jax_at_the_edges(i, plan):
    jenc, penc, table = _pair(i)
    rows = penc._grid_meta.tolist()
    p = {"own": penc.grid_fwd_plan, "no copies": lotd.GridFwdPlan(0, 0, 0),
         "other's": _pair(1 - i)[1].grid_fwd_plan}[plan]
    x = cs.k3_edge_points(300, 7)
    N, C = x.shape[0], penc.out_dim
    out, jac = torch.zeros(C, N), torch.zeros(3, C, N)
    lotd.lotd_grid_layout_plain(torch.from_numpy(table), torch.from_numpy(x), rows, p, out, jac)
    for (f, j), (_, _, _, nf, _, col) in zip(_jax_levels(jenc, table, x), rows):
        np.testing.assert_allclose(out[col:col + nf].numpy(), f, **TOL)
        np.testing.assert_allclose(jac[:, col:col + nf].numpy(), j, **TOL)
    # the layout changes where a value is read, never the value: the plain
    # version's bits
    want, wjac = torch.zeros(C, N), torch.zeros(3, C, N)
    lotd.lotd_grid_plain(torch.from_numpy(table), torch.from_numpy(x), penc._grid_meta,
                         want, wjac)
    assert torch.equal(out, want) and torch.equal(jac, wjac)


def test_plan_places_the_edge_levels():
    """Staged in level order while the copies fit GRID_FWD_SMEM_BUDGET, each
    level's F x size floats rounded up to 4; the rest interleaved."""
    places = []
    for i in range(len(cs.K3_EDGE_ENCODINGS)):
        e = _pair(i)[1]
        rows, plan = e._grid_meta.tolist(), e.grid_fwd_plan
        assert plan.n_shared * 4 <= lotd.GRID_FWD_SMEM_BUDGET
        places.append([w for w, _ in lotd.grid_fwd_places(rows, plan)])
        copies = lotd.grid_interleave_plain(e.table.detach() + 1.0, rows, plan)
        assert [c.numel() for c in copies] == [plan.n_shared, plan.n_inter]
    assert places == [["shared", "shared", "shared", "scratch", "shared", "scratch"],
                      ["scratch", "shared", "shared", "scratch"]]


def test_interleaved_copy_holds_each_row_as_its_features():
    e = _pair(0)[1]
    rows, plan = e._grid_meta.tolist(), e.grid_fwd_plan
    table = torch.arange(e.total_params, dtype=torch.float32)
    copies = dict(zip(("shared", "scratch"), lotd.grid_interleave_plain(table, rows, plan)))
    for (_, size, offset, nf, _, _), (where, off) in zip(rows, lotd.grid_fwd_places(rows, plan)):
        rows_f = copies[where][off:off + nf * size].view(size, nf)
        # row r, feature f: table[offset + f size + r]
        want = offset + torch.arange(nf)[None, :] * size + torch.arange(size)[:, None]
        assert torch.equal(rows_f, want.float())


def test_path_plans():
    """The vehicles' two dense levels (R 8 and 13, F 4: 55.6 KB) are staged;
    synthetic_object's two hash levels (256 KB each) go to the scratch."""
    veh = ConditionalLoTDNeuSField(n_instances=3, encoding_cfg=WAYMO_DEMO_MULTI[
        "assetbank_cfg"]["Vehicle"]["model_params"]["encoding_cfg"]).encoding
    obj = lotd.make_lotd(SYNTHETIC_OBJECT["assetbank_cfg"]["Main"]["model_params"]
                         ["encoding_cfg"])
    assert veh.grid_fwd_plan == lotd.GridFwdPlan(0b11, 4 * 729 + 4 * 2744, 0, 4)
    assert obj.grid_fwd_plan == lotd.GridFwdPlan(0, 0, 2 * 2 * 2 ** 15, 2)


def test_scratch_is_filled_again_where_the_table_changed():
    """GridScratch (the interleaved copy kept across K3 forward calls) asks
    for a fill on first use, after an in-place update of the table (as
    ModelAdam's copy_ makes), for another table and for another size."""
    table = torch.zeros(10)
    scratch = lotd.GridScratch()
    assert scratch.take(table, 4)[1]
    scratch.filled(table)
    assert not scratch.take(table, 4)[1]
    with torch.no_grad():
        table.copy_(torch.ones(10))
    assert scratch.take(table, 4)[1]
    scratch.filled(table)
    assert not scratch.take(table, 4)[1]
    assert scratch.take(table.clone(), 4)[1]
    assert scratch.take(table, 8)[1] and scratch.buf.numel() == 8
