"""The point sets on which the card checks (chip_smoke.py,
test_torch_kernels_cuda.py) hold K1's and K2's backwards (the CP lines'
gradients) to their plain versions, held here on the CPU: they must give the
kernels the cases they claim, in particular runs of equal cells in a warp,
and "every point in one cell" really in one cell of each CP resolution of
the street's and the vehicles' ladders (one run a warp along every axis).
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from neuralsim_torch.configs import WAYMO_DEMO_MULTI
from neuralsim_torch.fields.conditional import ConditionalLoTDNeuSField
from neuralsim_torch.fields.encodings import lotd

torch.set_num_threads(1)


def _ladders():
    """The CP resolutions of the street's and the vehicles' encodings."""
    cfgs = WAYMO_DEMO_MULTI["assetbank_cfg"]
    street = lotd.make_lotd(cfgs["Street"]["model_params"]["encoding_cfg"])
    veh = ConditionalLoTDNeuSField(
        n_instances=3, encoding_cfg=cfgs["Vehicle"]["model_params"]["encoding_cfg"]).encoding
    return {name: [s.res for s in e.specs if s.typ == "cp"]
            for name, e in (("street", street), ("vehicles", veh))}


@pytest.mark.parametrize("model", ["street", "vehicles"])
def test_one_cell_points_share_one_cell_of_every_level(model):
    """Every point, along every axis, in the same cell of each CP level, in
    float32 as the kernels compute the cell (clip(x) * (R - 1), floored)."""
    resolutions = _ladders()[model]
    assert len(resolutions) == {"street": 10, "vehicles": 6}[model]
    x = cs.one_cell_points(4096, resolutions, 4)
    assert x.dtype == np.float32 and x.shape == (4096, 3)
    for r in resolutions:
        cells = np.floor(x * np.float32(r - 1))
        assert (cells == cells[0]).all(), r


def test_cp_bwd_point_sets():
    """The sets the card checks hold each way on: a step's sorted samples
    (runs of equal cells: neighbouring samples of a ray share a cell at R
    16), the eikonal's 512 points, one cell, and partial warps."""
    sets = cs.cp_bwd_point_sets(64, 48, 1024, [16, 1024], 5)
    assert [(name, x.shape) for name, x in sets] == [
        ("64 rays x 48 sorted samples", (3072, 3)), ("512 uniform points", (512, 3)),
        ("every point in one cell", (3072, 3)), ("N=1", (1, 3)), ("N=33", (33, 3))]
    rays = sets[0][1][:58 * 48].reshape(58, 48, 3)  # the last 256 rows: knots and ends
    cells = np.floor(np.clip(rays, 0, 1) * 15)
    assert (cells[:, 1:] == cells[:, :-1]).all(-1).mean() > 0.5
