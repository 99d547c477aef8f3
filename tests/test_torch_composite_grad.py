"""Port parity: gradients of the volume composite K6 into alpha, rgb and
nablas, the plain PyTorch version under autograd against ``jax.grad`` of the
JAX ``volume_integrate`` on the CPU, and the backward wrapper (its plain
version here; the CUDA kernel is held to it in test_torch_kernels_cuda.py).

The buffer has masked lanes, fully masked rays and lanes with ``alpha == 1``,
where ``1 - alpha + 1e-10`` is 1e-10 and a backward that divided by it would
lose every digit. Tolerance: rtol 1e-4, atol 1e-5 (JAX differentiates an
associative scan of the transmittance product, torch a left-to-right loop).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.renderers.buffers import volume_integrate as jax_integrate
from neuralsim_torch.renderers.buffers import (volume_composite_bwd, volume_integrate)
from test_torch_composite import EDGES, _buffer, _edge_buffer

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
OUTS = ("vw", "mask_volume", "depth_volume", "rgb_volume", "normals_volume")
INS = ("alpha", "rgb", "nablas")


def _cotangents(buf, seed=3):
    rng = np.random.default_rng(seed)
    n, s = buf["t"].shape
    shapes = {"vw": (n, s), "mask_volume": (n,), "depth_volume": (n,),
              "rgb_volume": (n, 3), "normals_volume": (n, 3)}
    return {k: rng.normal(size=sh).astype(np.float32) for k, sh in shapes.items()}


def _jax_grads(buf, cot, outs, jit=False):
    def loss(alpha, rgb, nablas):
        r = jax_integrate({"t": jnp.asarray(buf["t"]), "mask": jnp.asarray(buf["mask"]),
                           "alpha": alpha, "rgb": rgb, "nablas": nablas})
        return sum(jnp.sum(r[k] * cot[k]) for k in outs)

    grad = jax.grad(loss, argnums=(0, 1, 2))
    return (jax.jit(grad) if jit else grad)(*(jnp.asarray(buf[k]) for k in INS))


def _port_grads(buf, cot, outs):
    ins = {k: torch.from_numpy(buf[k]).requires_grad_(True) for k in INS}
    r = volume_integrate({"t": torch.from_numpy(buf["t"]),
                          "mask": torch.from_numpy(buf["mask"]), **ins})
    loss = sum((r[k] * torch.from_numpy(cot[k])).sum() for k in outs)
    return torch.autograd.grad(loss, list(ins.values()), allow_unused=True)


@pytest.mark.parametrize("outs", [OUTS] + [(k,) for k in OUTS], ids=["all", *OUTS])
def test_composite_gradients_match_jax(outs):
    buf = _buffer(n=64, s=48, seed=1)
    buf["alpha"][::5, 40] = 1.0
    assert (buf["alpha"][buf["mask"]] == 1.0).any() and not buf["mask"][9].any()
    cot = _cotangents(buf)
    want = _jax_grads(buf, cot, outs)
    got = _port_grads(buf, cot, outs)
    for k, g, w in zip(INS, got, want):
        w = np.asarray(w)
        if g is None:
            assert not w.any(), k
            continue
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=k)
        assert not g.numpy()[~buf["mask"]].any(), k        # masked lanes get zero


@pytest.mark.parametrize("n,s", EDGES, ids=[f"S {s}" for _, s in EDGES])
def test_composite_gradients_at_edges_match_jax(n, s):
    """One sample, odd widths, a wholly masked row and runs of alpha == 1."""
    buf = _edge_buffer(n, s)
    cot = _cotangents(buf, seed=s)
    want = _jax_grads(buf, cot, OUTS, jit=True)  # one compile for the edge's shape
    got = _port_grads(buf, cot, OUTS)
    for k, g, w in zip(INS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=k)
        assert not g.numpy()[~buf["mask"]].any(), k        # masked lanes get zero


def test_backward_wrapper_matches_autograd_and_is_finite_at_alpha_one():
    buf = _buffer(n=64, s=48, seed=2)
    buf["alpha"][:, 10] = 1.0
    buf["mask"][:8, 10] = True
    cot = _cotangents(buf)
    want = _port_grads(buf, cot, OUTS)
    T = torch.from_numpy
    got = volume_composite_bwd(T(buf["t"]), T(buf["mask"]), T(buf["alpha"]), T(buf["rgb"]),
                               T(buf["nablas"]), *(T(cot[k]) for k in OUTS))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_backward_wrapper_without_payloads():
    buf = _buffer(n=16, s=48, seed=4)
    cot = _cotangents(buf)
    T = torch.from_numpy
    d_alpha, d_rgb, d_nablas = volume_composite_bwd(
        T(buf["t"]), T(buf["mask"]), T(buf["alpha"]), None, None,
        T(cot["vw"]), T(cot["mask_volume"]), T(cot["depth_volume"]), None, None)
    assert d_rgb is None and d_nablas is None
    want = _port_grads(buf, cot, OUTS[:3])[0]
    torch.testing.assert_close(d_alpha, want, rtol=1e-6, atol=1e-6)


def test_merge_and_integrate_returns_the_buffer():
    from neuralsim_torch.renderers.buffers import merge_and_integrate
    buf = {k: torch.from_numpy(v) for k, v in _buffer(n=8, s=48).items()}
    out = merge_and_integrate([buf])
    mb = out["merged_buffer"]
    assert mb["src"].dtype == torch.int32 and not mb["src"].any()
    assert mb["src"].shape == buf["t"].shape and mb["nablas"] is buf["nablas"]
