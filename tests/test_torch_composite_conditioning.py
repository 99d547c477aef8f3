"""The composite's gradients on ill-conditioned inputs, against a float64
yardstick, on the CPU: the JAX functions (``volume_integrate``, and the NeuS
alpha of ``neus_alpha_from_sdf`` before it) and the port's plain versions of
K6 and K12, both in float32, each measured by its distance from the port's
plain version run in float64 on the same inputs.

The inputs are scripts/torch_composite_conditioning.py's (K6's alphas u^4,
where a ray of one sample can have its weight sum at the depth's 1e-8 clamp;
K12 at inv_s 300 on rays whose lanes all sit on the sigmoid's flat tails),
at the shapes where the kernels and the float32 plain versions part by more
than chip_smoke.GRAD_REL on the card, and one well-posed shape. That script
holds the kernels to the same yardstick on the card. Where JAX's float32
function lies within GRAD_REL of float64 (GRAD_REL times the output's
largest float64 entry, the stated rounding of every backward in the port),
the port's float32 plain version must lie no further from it than JAX's
plus GRAD_REL; an output that JAX's float32 misses by more than that has no
float32 answer to hold the port to (the last bits of 1 - P at inv_s 300:
both miss it by ~100%), and is only printed (``-s``) with both distances.
One jitted JAX call a shape and function.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.neus import neus_alpha_from_sdf as jax_alpha
from neuralsim_tpu.renderers.buffers import volume_integrate as jax_integrate
from neuralsim_torch.renderers.buffers import volume_composite_bwd_plain
from neuralsim_torch.renderers.neus_composite import neus_composite_bwd_plain

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_composite_conditioning",
    Path(__file__).resolve().parent.parent / "scripts" / "torch_composite_conditioning.py")
tcc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tcc)

# (rays, samples): the shapes of the outputs that miss GRAD_REL on the card
# (K6 at one sample; K12 at 9, 17 and 64 samples), and a well-posed one
SHAPES = [(1, 1), (3, 9), (1, 17), (1, 64), (3, 129)]
OUTS = ("vw", "mask_volume", "depth_volume", "rgb_volume", "normals_volume")


def _cot(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _f64(xs):
    """Tensors of numpy arrays, float32 ones as float64."""
    return [torch.from_numpy(x).double() if x.dtype == np.float32 else torch.from_numpy(x)
            for x in xs]


def _check(name, jax_grads, port, exact, distances):
    for i, (j, p, w) in enumerate(zip(jax_grads, port, exact)):
        w = w.numpy()
        scale = float(np.abs(w).max()) or 1.0
        ej = float(np.abs(np.asarray(j, np.float64) - w).max())
        ep = float(np.abs(p.double().numpy() - w).max())
        distances.append((f"{name} output {i}", ej / scale, ep / scale))
        assert ep <= ej + tcc.GRAD_REL * scale or ej > tcc.GRAD_REL * scale, \
            (name, i, ej, ep, scale)


@pytest.mark.parametrize("n,s", SHAPES, ids=[f"rays {n} S {s}" for n, s in SHAPES])
def test_k6_backward_against_float64(n, s):
    seed = 1000 * s + n
    t, mask, alpha, rgb, nablas = tcc.k6_inputs(n, s, seed)
    cots = [_cot(sh, seed + i) for i, sh in enumerate(((n, s), (n,), (n,), (n, 3), (n, 3)))]

    def loss(a, c, nb):
        r = jax_integrate({"t": jnp.asarray(t), "mask": jnp.asarray(mask), "alpha": a, "rgb": c,
                           "nablas": nb})
        return sum(jnp.sum(r[k] * g) for k, g in zip(OUTS, cots))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*map(jnp.asarray, (alpha, rgb, nablas)))
    ins = [torch.from_numpy(v) for v in (t, mask, alpha, rgb, nablas)]
    got = volume_composite_bwd_plain(*ins, *map(torch.from_numpy, cots))
    exact = volume_composite_bwd_plain(*_f64([t, mask, alpha, rgb, nablas] + cots))
    distances = []
    _check(f"K6 bwd rays={n} S={s}", want, got, exact, distances)
    print(distances)


@pytest.mark.parametrize("n,s", SHAPES, ids=[f"rays {n} S {s}" for n, s in SHAPES])
def test_k12_backward_against_float64(n, s):
    seed = 1000 * s + n
    t, mask, sdf, nablas, d, rgb = tcc.k12_inputs(n, s, seed)
    anneal = tcc.ANNEALS[seed % 3]
    cots = [_cot(sh, seed + 10 + i) for i, sh in enumerate(
        ((n, s), (n,), (n,), (n, 3), (n, 3), (n, s)))]

    def loss(sd, nb, c, inv_s):
        true_cos = jnp.sum(jnp.asarray(d)[:, None, :] * nb, axis=-1)
        cos = -(jax.nn.relu(-true_cos * 0.5 + 0.5) * (1.0 - anneal)
                + jax.nn.relu(-true_cos) * anneal)
        tt = jnp.asarray(t)
        dt = jnp.concatenate([tt[..., 1:] - tt[..., :-1], jnp.ones_like(tt[..., :1]) * 1e-3], -1)
        m = jnp.asarray(mask)
        alpha = jnp.where(m, jax_alpha(sd, cos, dt, inv_s), 0.0)
        r = jax_integrate({"t": tt, "mask": m, "alpha": alpha, "rgb": c, "nablas": nb})
        return sum(jnp.sum(r[k] * g) for k, g in zip(OUTS, cots)) + jnp.sum(alpha * cots[5])

    g_sdf, g_nab, g_rgb, g_inv = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (sdf, nablas, rgb)), jnp.float32(300.0))
    T = torch.from_numpy
    ins = (T(t), T(mask), T(sdf), T(nablas), T(d), anneal, torch.tensor(300.0), T(rgb))
    got = neus_composite_bwd_plain(*ins, *map(T, cots))
    exact = neus_composite_bwd_plain(*_f64([t, mask, sdf, nablas, d]), anneal,
                                     torch.tensor(300.0, dtype=torch.float64),
                                     *_f64([rgb] + cots))
    # d inv_s: the port returns each ray's share, JAX the sum
    distances = []
    _check(f"K12 bwd rays={n} S={s} anneal={anneal:g}",
           [g_sdf, g_nab, g_rgb, np.asarray(g_inv)[None]],
           [got[0], got[1], got[2], got[3].sum()[None]],
           [exact[0], exact[1], exact[2], exact[3].sum()[None]], distances)
    print(distances)
