"""Port parity for the permutohedral NeuS fields: the conditional field
(``ConditionalPermutoNeuSField``) and the plain permuto object
(``PermutoNeuSObj``, d = 3), against the JAX package on the CPU, with the
JAX parameters carried over through ``load_jax_params``.

Conditional field: 3 instances, z_dim 8 (d = 11), 3 lattice levels to 32 on
a 2^12 table (table and latents moved off their init); sdf, feature and
nablas at 512 points (a fifth outside the box) with and without ``bidx``
(indices out of range clamp), against the JAX field run op by op: the port's
lattice is that math op for op (see test_torch_permuto.py), so every point
is held, to 1e-5 of the largest entry (measured <= 2.3e-7). Jitted, XLA
reorders the lattice's rounding: it puts a clipped point (on a lattice face,
where ties decide the rank) on another simplex now and then, and moves the
weights by an ulp of the elevated coordinate, 4e-5 of the sdf at 12 levels to
512; test_torch_permuto_multi.py holds the slice's steps to the jitted JAX at
the limits stated there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.conditional import ConditionalPermutoNeuSField as JaxField
from neuralsim_tpu.fields.spatial import AABBSpace as JaxSpace
from neuralsim_tpu.models.assets import PermutoNeuSObj as JaxPermutoObj
from neuralsim_torch.bridge import flatten_tree, load_jax_params
from neuralsim_torch.fields.conditional import ConditionalPermutoNeuSField
from neuralsim_torch.fields.spatial import AABBSpace
from neuralsim_torch.models.assets import PermutoNeuSObj, asset_class

torch.set_num_threads(1)

FIELD_REL = 1e-5


def _rel_by_point(got, want):
    """Each point's largest error over the largest entry of ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).reshape(len(want), -1).max(-1) / np.abs(want).max()


def _moved_off_init(tree, rng):
    tree["encoding"]["table"] = (np.asarray(tree["encoding"]["table"])
                                 + rng.normal(0, 0.1, tree["encoding"]["table"].shape)
                                 ).astype(np.float32)
    if "latents" in tree:
        tree["latents"] = rng.normal(0, 0.5, tree["latents"].shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def field_pair():
    lo, hi = [-1.0, -0.5, -0.4], [1.0, 0.5, 0.4]
    kw = dict(n_instances=3, z_dim=8, geo_feat_dim=7, radiance_hidden=16,
              permuto_cfg={"n_levels": 3, "base_res": 4.0, "max_res": 32.0,
                           "log2_hashmap_size": 12})
    jf = JaxField(JaxSpace(lo, hi), **kw)
    pf = ConditionalPermutoNeuSField(AABBSpace(lo, hi), **kw)
    jp = _moved_off_init(jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(3))),
                         np.random.default_rng(3))
    load_jax_params(pf, jp)
    rng = np.random.default_rng(4)
    x = (rng.random((512, 3)) * 2.4 - 1.2).astype(np.float32) * np.array(hi, np.float32)
    bidx = rng.integers(-1, 5, 512).astype(np.int32)   # -1 and 3, 4 clamp
    return jf, pf, jp, x, bidx


def test_field_layout_matches_jax(field_pair):
    jf, pf, jp, _, _ = field_pair
    assert pf.encoding.input_dim == jf.encoding.input_dim == 11
    assert pf.encoding.out_dim == jf.encoding.out_dim == 6
    assert pf.decoder.in_dim == jf.encoding.out_dim       # the latent is in the lattice
    assert set(flatten_tree(jp)) == set(dict(pf.named_parameters()))
    assert float(pf.latent_norm().detach()) == pytest.approx(float(jf.latent_norm(jp)), rel=1e-6)


@pytest.mark.parametrize("with_bidx", [False, True], ids=["instance 0", "bidx"])
def test_field_queries_match_jax(field_pair, with_bidx):
    jf, pf, jp, x, bidx = field_pair
    params = jax.tree.map(jnp.asarray, jp)
    b = jnp.asarray(bidx) if with_bidx else None
    pb = torch.from_numpy(bidx).long() if with_bidx else None
    with jax.disable_jit():
        w_sdf, w_feat = jf.query_sdf_feat(params, jnp.asarray(x), bidx=b)
        w_s, w_n, w_f = jf.sdf_nablas_feat(params, jnp.asarray(x), bidx=b)
    with torch.no_grad():
        sdf, feat = pf.query_sdf_feat(torch.from_numpy(x), bidx=pb)
        s, n, f = pf.sdf_nablas_feat(torch.from_numpy(x), bidx=pb)
    for got, want in ((sdf, w_sdf), (feat, w_feat), (s, w_s), (f, w_f), (n, w_n)):
        assert _rel_by_point(got.numpy(), want).max() <= FIELD_REL
    # the instance matters: another latent, another sdf
    if with_bidx:
        with torch.no_grad():
            s0 = pf.query_sdf_feat(torch.from_numpy(x))[0]
        assert float((s0 - sdf).abs().max()) > 1e-3


def test_plain_permuto_object_matches_jax():
    """PermutoNeuSObj: the unconditioned field, d = 3, built by both
    packages' assets: the default ladder (12 levels to 512, 2^17 rows) alike,
    and queried at 4 levels of that ladder's growth on a 2^12 table."""
    ja, pa = JaxPermutoObj({}), PermutoNeuSObj({})
    ja.populate()
    pa.populate()
    assert asset_class("neuralsim_tpu.models.assets.PermutoNeuSObj") is PermutoNeuSObj
    assert pa.field.encoding.input_dim == 3 and pa.field.n_instances == 0
    assert pa.field.encoding.levels == [(float(r), f) for r, f in ja.field.encoding.levels]
    assert pa.field.encoding.total_params == ja.field.encoding.total_params == 12 * 2 * 2 ** 17
    mp = {"extent": 1.5, "geo_feat_dim": 7, "radiance_hidden": 16,
          "permuto_cfg": {"n_levels": 4, "base_res": 4.0, "max_res": 25.0,
                          "log2_hashmap_size": 12}}
    ja, pa = JaxPermutoObj(mp), PermutoNeuSObj(mp)
    ja.populate()
    pa.populate()
    jp = _moved_off_init(jax.tree.map(np.asarray, ja.field.init(jax.random.PRNGKey(5))),
                         np.random.default_rng(5))
    load_jax_params(pa.field, jp)
    x = (np.random.default_rng(6).random((512, 3)) * 3.2 - 1.6).astype(np.float32)
    with jax.disable_jit():
        w_s, w_n, w_f = ja.field.sdf_nablas_feat(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    with torch.no_grad():
        s, n, f = pa.field.sdf_nablas_feat(torch.from_numpy(x))
    for got, want in ((s, w_s), (f, w_f), (n, w_n)):
        assert _rel_by_point(got.numpy(), want).max() <= FIELD_REL


def test_time_conditioned_assets_and_field_refuse():
    for name in ("ADDynamicGenerativePermutoConcatNeuSObj", "DynamicPermutoConcatNeuSObj"):
        with pytest.raises(NotImplementedError, match=f"{name} is not ported"):
            asset_class(f"neuralsim_tpu.models.assets.{name}")
    with pytest.raises(NotImplementedError, match="time-conditioned"):
        ConditionalPermutoNeuSField(n_instances=2, use_time=True)
