"""Port parity: the volume composite kernel K6 (alpha -> transmittance ->
mask/depth/rgb/normals sums), plain PyTorch version against the JAX
``volume_integrate`` on the CPU (the CUDA kernel is held to this plain
version in test_torch_kernels_cuda.py).

Tolerance: atol 1e-6, rtol 1e-5 — only the order of the transmittance
product (JAX: associative scan) and of the sums differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import composite_edge_inputs
from neuralsim_tpu.renderers.buffers import volume_integrate as jax_integrate
from neuralsim_torch.renderers.buffers import volume_integrate

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
KEYS = ("vw", "mask_volume", "depth_volume", "rgb_volume", "normals_volume", "samples_cnt")


def _buffer(n=128, s=96, seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.random((n, s)) * 3.0, -1).astype(np.float32)
    alpha = (rng.random((n, s)) ** 4).astype(np.float32)
    alpha[::5, 40] = 1.0                                  # opaque samples
    mask = rng.random((n, s)) > 0.1
    mask[::9] = False                                     # fully masked rays
    rgb = rng.random((n, s, 3)).astype(np.float32)
    nablas = rng.normal(size=(n, s, 3)).astype(np.float32)
    return {"t": t, "mask": mask, "alpha": alpha, "rgb": rgb, "nablas": nablas}


def test_k6_composite_matches_jax():
    buf = _buffer()
    want = jax_integrate({k: jnp.asarray(v) for k, v in buf.items()})
    got = volume_integrate({k: torch.from_numpy(v) for k, v in buf.items()})
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    assert got["samples_cnt"].dtype == torch.int32
    dead = ~buf["mask"].any(-1)
    assert dead.sum() >= 10
    for k in KEYS:
        assert np.all(got[k].numpy()[dead] == 0), k



# the kernels' lane groups and chunks at their edges: one sample, odd widths
# across a group; rows wholly masked (row 1) and runs of alpha == 1 lanes
# (every third row from row 2), as chip_smoke's card checks make them
EDGES = [(4, 1), (6, 7), (5, 33)]


def _edge_buffer(n, s):
    keys = ("t", "mask", "alpha", "rgb", "nablas")
    return dict(zip(keys, composite_edge_inputs(n, s, 1000 * s + n)))


@pytest.mark.parametrize("n,s", EDGES, ids=[f"S {s}" for _, s in EDGES])
def test_k6_composite_edges_match_jax(n, s):
    buf = _edge_buffer(n, s)
    want = jax.jit(jax_integrate)({k: jnp.asarray(v) for k, v in buf.items()})  # one compile
    got = volume_integrate({k: torch.from_numpy(v) for k, v in buf.items()})
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    assert not got["mask_volume"][1] and not got["depth_volume"][1]   # 0 / 1e-8
    if s > 1:
        assert (buf["alpha"][buf["mask"]] == 1.0).sum() >= 3
