"""Port parity for the latent lookup (kernel K13) and its backward: the plain
version against ``jnp.take(latents, bidx, axis=0, mode="clip")`` and its
``jax.vjp`` on the CPU, and the latents' gradient of both conditional fields
(``ConditionalLoTDNeuSField`` at the decoder input, ``ConditionalPermutoNeuSField``
in the lattice) against the JAX fields from the same parameters
(``load_jax_params`` carries the JAX ``latents`` and ``encoding.table``
leaves across).

Cases: indices below 0 and at or past n (clamped), no index (instance 0),
one index a ray over S samples, n 1, 3 and 8, long runs (the compose
renderer's compacted rows) and interleaved indices (the crowd's round-robin
rows), int32 and int64, and a strided cotangent (a column slice of a wider
gradient, as the decoder input's concatenation hands it back).

Tolerances: the forward is a gather, exact. The VJP sums up to 4,096 rows an
instance in another order than JAX's scatter-add: within 1e-6 of the largest
entry (VJP_REL). The fields' latent gradients sum 256 points' float32 terms
through the decoder (and for the permuto field the lattice) in another order:
within 1e-5 of the largest entry (FIELD_REL; measured below 1e-6 on both).
The permuto field takes the sigmoid of the latents before the lookup, JAX
after it: the same forward values, and the gradient within that rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.conditional import ConditionalLoTDNeuSField as JaxLoTDField
from neuralsim_tpu.fields.conditional import ConditionalPermutoNeuSField as JaxPermutoField
from neuralsim_tpu.fields.spatial import AABBSpace as JaxSpace
from neuralsim_torch.bridge import load_jax_params
from neuralsim_torch.fields.conditional import (ConditionalLoTDNeuSField,
                                                ConditionalPermutoNeuSField)
from neuralsim_torch.fields.spatial import AABBSpace
from neuralsim_torch.ops.latent_take import (LatentTake, latent_take, latent_take_bwd,
                                             latent_take_bwd_plain, latent_take_plain)

torch.set_num_threads(1)

VJP_REL = 1e-6
FIELD_REL = 1e-5
BOX = ([-1.0, -0.5, -0.8], [1.0, 0.5, 0.8])

# label: (n instances, z, points, indices (numpy) or None, points an index)
_rng = np.random.default_rng(0)
CASES = {
    "clamped": (3, 8, 2048, _rng.integers(-2, 6, 2048), 1),
    "no index": (3, 8, 1024, None, 1),
    "per ray, S 16": (3, 8, 4096, _rng.integers(-1, 4, 256), 16),
    "n 1": (1, 4, 512, _rng.integers(-1, 3, 512), 1),
    "n 8 interleaved": (8, 8, 4096, np.arange(4096) % 9 - 1, 1),
    "n 8 interleaved rays, S 32": (8, 8, 8192, (np.arange(256) * 5) % 8, 32),
    "long runs": (3, 8, 12288, np.repeat(np.arange(3), 128), 32),
    "int32": (3, 5, 999, _rng.integers(-3, 7, 999).astype(np.int32), 1),
}


def _case(label):
    n, z, P, idx, per = CASES[label]
    rng = np.random.default_rng(len(label))
    lat = rng.normal(0.0, 1.0, (n, z)).astype(np.float32)
    g = rng.normal(0.0, 1.0, (P, z)).astype(np.float32)
    per_point = np.zeros(P, np.int64) if idx is None else np.repeat(idx, per)
    return lat, idx, P, g, per_point


def _jax_take(lat, per_point):
    return lambda l: jnp.take(l, jnp.asarray(per_point, jnp.int32), axis=0, mode="clip")


@pytest.mark.parametrize("label", list(CASES))
def test_plain_latent_take_matches_jax(label):
    lat, idx, P, g, per_point = _case(label)
    ti = None if idx is None else torch.from_numpy(idx)
    want, vjp = jax.vjp(_jax_take(lat, per_point), jnp.asarray(lat))
    got = latent_take_plain(torch.from_numpy(lat), ti, P)
    assert got.shape == (P, lat.shape[1]) and np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(latent_take(torch.from_numpy(lat), ti, P), got)
    d_want = np.asarray(vjp(jnp.asarray(g))[0])
    d_got = latent_take_bwd_plain(torch.from_numpy(g), ti, lat.shape[0]).numpy()
    np.testing.assert_allclose(d_got, d_want, rtol=VJP_REL,
                               atol=VJP_REL * np.abs(d_want).max())
    assert torch.equal(latent_take_bwd(torch.from_numpy(g), ti, lat.shape[0]),
                       torch.from_numpy(d_got))


@pytest.mark.parametrize("label", ["clamped", "per ray, S 16", "n 8 interleaved"])
def test_latent_take_function_with_a_strided_cotangent(label):
    """LatentTake under autograd, its output concatenated after 6 other
    columns: the cotangent reaches it as a column slice."""
    lat, idx, P, g, per_point = _case(label)
    _, vjp = jax.vjp(_jax_take(lat, per_point), jnp.asarray(lat))
    d_want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(lat).requires_grad_(True)
    h = torch.zeros(P, 6)
    out = torch.cat([h, LatentTake.apply(t, None if idx is None else torch.from_numpy(idx), P)],
                    dim=-1)
    out.backward(torch.cat([torch.ones(P, 6), torch.from_numpy(g)], dim=-1))
    np.testing.assert_allclose(t.grad.numpy(), d_want, rtol=VJP_REL,
                               atol=VJP_REL * np.abs(d_want).max())


def test_per_ray_view_is_read_per_ray():
    """A [rays, S] index broadcast over its samples (what ray_query passes)
    looks up the same rows as the index expanded to every sample."""
    f = ConditionalLoTDNeuSField(AABBSpace(*BOX), n_instances=3, z_dim=4,
                                 encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32,
                                               "n_feats": 2, "cp_max_res": 32})
    with torch.no_grad():
        f.latents.copy_(torch.randn(3, 4, generator=torch.Generator().manual_seed(0)))
    bidx = torch.tensor([2, -1, 5, 1])
    view = bidx[:, None].expand(4, 8)
    got = f._instance_latents(torch.Size([32]), view)
    want = f._instance_latents(torch.Size([32]), view.reshape(-1))
    assert torch.equal(got, want) and torch.equal(got[8], f.latents[0].detach())


# ---------------------------------------------------------------------------
# The conditional fields' latent gradients
# ---------------------------------------------------------------------------

def _loss_weights(n, rng):
    return (rng.normal(0, 1, n).astype(np.float32), rng.normal(0, 1, (n, 3)).astype(np.float32))


def _pair(kind):
    rng = np.random.default_rng(5)
    if kind == "lotd":
        kw = dict(n_instances=3, z_dim=8, geo_feat_dim=5, radiance_hidden=8,
                  encoding_cfg={"n_levels": 4, "base_res": 4, "max_res": 32, "n_feats": 2,
                                "cp_max_res": 32})
        jf, pf = JaxLoTDField(JaxSpace(*BOX), **kw), ConditionalLoTDNeuSField(AABBSpace(*BOX), **kw)
    else:
        kw = dict(n_instances=3, z_dim=8, geo_feat_dim=7, radiance_hidden=16,
                  permuto_cfg={"n_levels": 3, "base_res": 4.0, "max_res": 32.0,
                               "log2_hashmap_size": 12})
        jf = JaxPermutoField(JaxSpace(*BOX), **kw)
        pf = ConditionalPermutoNeuSField(AABBSpace(*BOX), **kw)
    jp = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(1)))
    jp["encoding"]["table"] = (jp["encoding"]["table"]
                               + rng.normal(0, 0.1, jp["encoding"]["table"].shape)
                               ).astype(np.float32)
    jp["latents"] = rng.normal(0, 0.5, jp["latents"].shape).astype(np.float32)
    load_jax_params(pf, jp)
    return jf, jp, pf


@pytest.fixture(scope="module")
def fields():
    return {kind: _pair(kind) for kind in ("lotd", "permuto")}


@pytest.mark.parametrize("form", ["per point", "per ray"])
@pytest.mark.parametrize("kind", ["lotd", "permuto"])
def test_conditional_field_latent_gradient_matches_jax(fields, kind, form):
    """d/d latents of sum(sdf w1) + sum(nablas w3) at 256 points (a fifth
    outside the box; indices -1..4, clamped), port against JAX."""
    jf, jp, pf = fields[kind]
    rng = np.random.default_rng(6)
    x = (rng.uniform(-1.2, 1.2, (256, 3)) * np.array(BOX[1])).astype(np.float32)
    rays = rng.integers(-1, 5, 32)
    bidx = np.repeat(rays, 8)
    w1, w3 = _loss_weights(256, rng)

    def jax_loss(lat):
        sdf, nablas, _ = jf.sdf_nablas_feat({**jp, "latents": lat}, jnp.asarray(x),
                                            bidx=jnp.asarray(bidx, jnp.int32))
        return jnp.sum(sdf * w1) + jnp.sum(nablas * w3)

    with jax.disable_jit():   # the permuto lattice equals JAX op by op, not jitted
        want = np.asarray(jax.grad(jax_loss)(jnp.asarray(jp["latents"])))
    tb = torch.from_numpy(rays)[:, None].expand(32, 8) if form == "per ray" \
        else torch.from_numpy(bidx)
    pf.zero_grad(set_to_none=True)
    sdf, nablas, _ = pf.sdf_nablas_feat(torch.from_numpy(x), bidx=tb)
    ((sdf * torch.from_numpy(w1)).sum() + (nablas * torch.from_numpy(w3)).sum()).backward()
    got = pf.latents.grad.numpy()
    assert np.abs(want).max() > 0 and not np.any(want[np.unique(np.clip(rays, 0, 2))] == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=FIELD_REL * np.abs(want).max())
