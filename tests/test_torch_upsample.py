"""Port parity: the NeuS upsample kernel K5 — (a) upsample weights plus the
inverse-CDF draws, (b) the rank merge — plain PyTorch versions against the
JAX package on the CPU (the CUDA kernels are held to these plain versions in
test_torch_kernels_cuda.py).

Tolerances: the weights differ from JAX only by the order of the
transmittance product (JAX uses an associative scan): rtol 1e-5, atol 1e-7.
The draws differ by the cdf's cumsum order: rtol 1e-5, atol 1e-6 (depths
are O(1)). The merge moves values without arithmetic, so it is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.neus import sdf_to_upsample_weights as jax_weights
from neuralsim_tpu.ops.segment import merge_sorted_samples as jax_merge
from neuralsim_tpu.ops.segment import sample_pdf as jax_sample_pdf
from neuralsim_torch.fields.neus import upsample_weights_pdf
from neuralsim_torch.ops.segment import merge_sorted_samples

torch.set_num_threads(1)

W_TOL = dict(rtol=1e-5, atol=1e-7)
T_TOL = dict(rtol=1e-5, atol=1e-6)


def _stage_inputs(n=96, s=24, seed=0):
    """Sorted depths on [near, far] with a surface crossing, some masked
    lanes and some fully missed rays (near = far = 0, mask all False)."""
    rng = np.random.default_rng(seed)
    near = (0.5 + rng.random(n)).astype(np.float32)
    far = (near + 1.0 + rng.random(n)).astype(np.float32)
    u = np.sort(rng.random((n, s)), -1).astype(np.float32)
    t = (near[:, None] + (far - near)[:, None] * u).astype(np.float32)
    surf = near + (far - near) * rng.random(n)
    sdf = (surf[:, None] - t + rng.normal(0, 0.02, (n, s))).astype(np.float32)
    mask = np.ones((n, s), bool)
    mask[::7, -3:] = False
    miss = np.arange(n) % 11 == 0
    t[miss], near[miss], far[miss], mask[miss] = 0.0, 0.0, 0.0, False
    return t, sdf, mask, near, far


def _k5a_vs_jax(s, nf, inv_s, noisy, seed):
    """The plain K5a against the JAX weights and inverse CDF at ``s``
    samples and ``nf`` draws, with drawn noise where ``noisy``."""
    t, sdf, mask, near, far = _stage_inputs(s=s, seed=seed)
    noise = np.random.default_rng(2).random((t.shape[0], nf)).astype(np.float32) \
        if noisy else None
    w_j = jax_weights(jnp.asarray(t), jnp.asarray(sdf), jnp.asarray(mask), inv_s)
    bins = jnp.concatenate([jnp.asarray(t), jnp.maximum(far, near + 1e-4)[:, None]], -1)
    if noisy:
        # the JAX sampler draws u = (k + U) / n from a key; feed the same U
        u = (np.arange(nf) + noise) / nf
        want_t = _jax_sample_pdf_at(bins, w_j, jnp.asarray(u, jnp.float32))
    else:
        want_t = jax_sample_pdf(bins, w_j, nf, det=True)
    w_p, t_p = upsample_weights_pdf(
        torch.from_numpy(t), torch.from_numpy(sdf), torch.from_numpy(mask),
        torch.from_numpy(near), torch.from_numpy(far), inv_s, nf,
        None if noise is None else torch.from_numpy(noise))
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), **W_TOL)
    np.testing.assert_allclose(t_p.numpy(), np.asarray(want_t), **T_TOL)
    assert np.all(np.diff(t_p.numpy(), axis=-1) >= 0)
    assert np.all(w_p.numpy()[~mask] == 0.0)
    _, t_only = upsample_weights_pdf(
        torch.from_numpy(t), torch.from_numpy(sdf), torch.from_numpy(mask),
        torch.from_numpy(near), torch.from_numpy(far), inv_s, nf,
        None if noise is None else torch.from_numpy(noise), with_weights=False)
    assert torch.equal(t_only, t_p)


@pytest.mark.parametrize("noisy", [False, True])
def test_k5a_weights_and_pdf_match_jax(noisy):
    _k5a_vs_jax(24, 16, 64.0 * 4.0, noisy, 0)


@pytest.mark.parametrize("s,inv_s", [(24, 64.0), (32, 64.0), (40, 256.0)])
def test_k5a_matches_jax_at_the_stage_widths(s, inv_s):
    """The multi-object iteration's stages: 24, 32 and 40 samples, 8 drawn
    draws each."""
    _k5a_vs_jax(s, 8, inv_s, True, 40 + s)


def _jax_sample_pdf_at(bins, weights, u, eps=1e-5):
    """The body of the JAX sample_pdf at given draws u [N, n] (its key-driven
    branch computes exactly this with u from jax.random)."""
    w = weights + eps
    csum = jnp.cumsum(w, axis=-1)
    cdf = jnp.concatenate([jnp.zeros_like(csum[..., :1]), csum], axis=-1) / csum[..., -1:]
    c0, c1 = cdf[..., None, :-1], cdf[..., None, 1:]
    seg = jnp.clip((u[..., :, None] - c0) / jnp.maximum(c1 - c0, 1e-12), 0.0, 1.0)
    dt = (bins[..., 1:] - bins[..., :-1])[..., None, :]
    return bins[..., :1] + jnp.sum(seg * dt, axis=-1)


def test_sample_pdf_at_matches_jax_key_branch():
    """Pins the helper above to the JAX key branch: same u gives the same t."""
    t, sdf, mask, near, far = _stage_inputs(seed=3)
    bins = jnp.concatenate([jnp.asarray(t), jnp.maximum(far, near + 1e-4)[:, None]], -1)
    w = jax_weights(jnp.asarray(t), jnp.asarray(sdf), jnp.asarray(mask), 64.0)
    key = jax.random.PRNGKey(0)
    u = (jnp.arange(8) + jax.random.uniform(key, (t.shape[0], 8))) / 8
    np.testing.assert_array_equal(np.asarray(_jax_sample_pdf_at(bins, w, u)),
                                  np.asarray(jax_sample_pdf(bins, w, 8, key=key)))


def _merge_inputs(n=64, a=24, b=8, seed=5, levels=40):
    """Sorted depths on a grid of ``levels`` values (few levels: ties inside
    each list and across), a tie across in every ray, masked lanes."""
    rng = np.random.default_rng(seed)
    ta = np.sort(rng.integers(0, levels, (n, a)) / 8.0, -1).astype(np.float32)
    tb = (rng.integers(0, levels, (n, b)) / 8.0).astype(np.float32)
    tb[:, 0] = ta[:, 3]                                   # a tie in every ray
    tb = np.sort(tb, -1)
    ma = rng.random((n, a)) > 0.2
    mb = rng.random((n, b)) > 0.2
    sa = rng.normal(size=(n, a)).astype(np.float32)
    sb = rng.normal(size=(n, b)).astype(np.float32)
    return ta, tb, ma, mb, sa, sb


def test_k5b_merge_matches_jax_exactly():
    ta, tb, ma, mb, sa, sb = _merge_inputs()
    want = jax_merge(jnp.asarray(ta), jnp.asarray(tb), (jnp.asarray(ma), jnp.asarray(mb)),
                     (jnp.asarray(sa), jnp.asarray(sb)))
    got = merge_sorted_samples(*(torch.from_numpy(v) for v in (ta, tb, ma, mb, sa, sb)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.all(np.diff(got[0].numpy(), axis=-1) >= 0)
    # on a tie the first list's element goes first: the ray's first tied
    # slot carries the payload of ta[:, 3]
    t, s = got[0].numpy(), got[2].numpy()
    for r in range(t.shape[0]):
        first = np.flatnonzero(t[r] == ta[r, 3])[0]
        a_first = np.flatnonzero(ta[r] == ta[r, 3])[0]
        assert s[r, first] == sa[r, a_first]



@pytest.mark.parametrize("levels", [40, 3], ids=["ties across", "ties everywhere"])
@pytest.mark.parametrize("a,b", [(32, 8), (40, 8), (24, 8)])
def test_k5b_merge_at_the_multi_object_stage_widths(a, b, levels):
    """The multi-object upsample stages: the street's 32 -> 40 -> 48 and the
    vehicles' 24 -> 32, 8 draws each; the merged depths, masks and sdf equal
    JAX's exactly, ties and masked lanes included."""
    ta, tb, ma, mb, sa, sb = _merge_inputs(n=37, a=a, b=b, seed=a + levels, levels=levels)
    want = jax_merge(jnp.asarray(ta), jnp.asarray(tb), (jnp.asarray(ma), jnp.asarray(mb)),
                     (jnp.asarray(sa), jnp.asarray(sb)))
    got = merge_sorted_samples(*(torch.from_numpy(v) for v in (ta, tb, ma, mb, sa, sb)))
    assert got[0].shape == (37, a + b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
