"""K3's backward (the dense/hash gather levels' table gradient) splits its
levels into private ones, summed in each block's shared memory on the card,
and global ones, summed with device atomics. The split and the scratch it
needs are plain functions of the encoding's level metadata, held here on
the CPU (the kernel itself is held to its plain version in
test_torch_kernels_cuda.py)."""
import pytest
import torch

import chip_smoke as cs
from neuralsim_torch.configs import (BENCH_OBJECT, SYNTHETIC_MULTI, SYNTHETIC_OBJECT,
                                    WAYMO_DEMO_MULTI)
from neuralsim_torch.fields.conditional import ConditionalLoTDNeuSField
from neuralsim_torch.fields.encodings import lotd

torch.set_num_threads(1)


def _encoding_cfg(cfg, model):
    return cfg["assetbank_cfg"][model]["model_params"]["encoding_cfg"]


def _vehicles():
    """The vehicles' encoding as their conditional field builds it."""
    return ConditionalLoTDNeuSField(
        n_instances=3, encoding_cfg=_encoding_cfg(WAYMO_DEMO_MULTI, "Vehicle")).encoding


def _private_levels(plan, n_levels):
    return [l for l in range(n_levels) if plan.private_mask >> l & 1]


def test_the_vehicles_two_dense_levels_are_private():
    enc = _vehicles()
    rows = enc._grid_meta.tolist()
    assert [(r[0], r[1], r[3], r[4]) for r in rows] == [(8, 729, 4, 0), (13, 2744, 4, 0)]
    plan = enc.grid_bwd_plan
    assert _private_levels(plan, len(rows)) == [0, 1]
    assert plan.n_private == 4 * (729 + 2744) == 13_892
    assert plan.n_private * 4 <= lotd.GRID_BWD_SMEM_BUDGET


@pytest.mark.parametrize("cfg,model", [(SYNTHETIC_OBJECT, "Main"), (SYNTHETIC_MULTI, "Street")],
                         ids=["synthetic_object", "synthetic_multi street"])
def test_hash_levels_stay_global(cfg, model):
    enc = lotd.make_lotd(_encoding_cfg(cfg, model))
    rows = enc._grid_meta.tolist()
    hashed = [l for l, r in enumerate(rows) if r[4]]
    assert len(hashed) == 2 and all(rows[l][1] == 2 ** 15 for l in hashed)
    private = _private_levels(enc.grid_bwd_plan, len(rows))
    assert not set(private) & set(hashed)
    # synthetic_multi's street has two dense levels below its hash levels
    assert private == [l for l, r in enumerate(rows) if not r[4]]


def test_small_encoding_is_part_private_part_global():
    enc = cs.small_encoding("cpu")
    rows = enc._grid_meta.tolist()
    assert [r[4] for r in rows] == [0, 0, 1, 1]
    assert _private_levels(enc.grid_bwd_plan, len(rows)) == [0, 1]
    assert enc.grid_bwd_plan.n_private == 2 * (729 + 2197)


def test_levels_past_the_budget_go_global():
    """Dense levels in level order while they fit the 96 KB together: the
    third (48 KB more) overflows and goes global, the fourth (small) still
    fits; a level larger than the budget alone is global."""
    rows = [(8, 729, 0, 4, 0, 0), (13, 2744, 2916, 4, 0, 4), (20, 3072, 13892, 4, 0, 8),
            (4, 125, 26180, 4, 0, 12)]
    plan = lotd.grid_bwd_plan(rows)
    assert _private_levels(plan, 4) == [0, 1, 3]
    assert plan.n_private == 4 * (729 + 2744 + 125)
    assert (plan.n_private + 4 * 3072) * 4 > lotd.GRID_BWD_SMEM_BUDGET
    big = lotd.GRID_BWD_SMEM_BUDGET // 4 + 1
    assert lotd.grid_bwd_plan([(40, big, 0, 1, 0, 0)]) == (0, 0)


def test_only_the_first_31_levels_can_be_private():
    """The kernel takes the split as a 31-bit mask of level indices."""
    rows = [(1, 8, 8 * l, 1, 0, l) for l in range(40)]
    plan = lotd.grid_bwd_plan(rows)
    assert plan.private_mask == (1 << 31) - 1 and plan.n_private == 31 * 8


def test_no_gather_level_gives_an_empty_split():
    assert lotd.grid_bwd_plan([]) == (0, 0)
    enc = lotd.make_lotd(BENCH_OBJECT["models"]["cr"]["params"]["encoding_cfg"])
    assert not enc.grid_spec_ids and enc.grid_bwd_plan == (0, 0)
    assert enc.grid_bwd_plan.at(8192 * 32) == (0, 0)


@pytest.mark.parametrize("n_points,private", [(3 * 2048 * 32, True), (8 * 13_892, True),
                                              (8 * 13_892 - 1, False), (512, False), (1, False),
                                              (0, False)])
def test_the_scratch_follows_the_split(n_points, private):
    """A launch of 8 points a private float or more keeps the vehicles'
    private levels: each block of the persistent grid sums its own copy of
    their 13,892 floats, one row of the scratch. A smaller one (the uniform
    eikonal's 512 points) takes device atomics and needs no scratch."""
    plan = _vehicles().grid_bwd_plan.at(n_points)
    assert plan == ((3, 13_892) if private else (0, 0))
    glob = lotd.grid_bwd_plan([(172, 32768, 0, 2, 1, 0)])
    assert glob == glob.at(n_points) == (0, 0)


def test_the_wrapper_takes_a_plan_and_the_encoding_makes_its_own():
    """On the CPU the wrapper is the plain version whatever the plan; the
    encoding's plan is the one the wrapper makes from the meta without it."""
    enc = cs.small_encoding("cpu")
    assert enc.grid_bwd_plan == lotd.grid_bwd_plan(enc._grid_meta.tolist())
    x = torch.from_numpy(cs.ray_points(64, 8, 64, 0))
    n = x.shape[0]
    d_out = cs.cotangents((enc.out_dim, n), 1, "cpu")
    d_jac = cs.cotangents((3, enc.out_dim, n), 2, "cpu")
    args = (enc.total_params, x, enc._grid_meta, d_out, d_jac)
    torch.testing.assert_close(lotd.lotd_grid_bwd(*args, plan=enc.grid_bwd_plan),
                               lotd.lotd_grid_bwd_plain(*args), rtol=0, atol=0)
