"""Port parity for EmerNeRF (configs/waymo_emernerf.yaml's close range) against
the JAX package on the CPU: the field's query at several times and with the
dynamic branch alone, its buffer, the flow cycle and its gradients, the
single-volume renderer's time condition and decomposition channels (and
``render_chunked``), and the single-scene trainer's time condition, first
step and three steps with the flow and dynamic-sparsity losses.

Small size: a static LoTD of 4 NGP levels (8 .. 32: two dense, two hash of
2^10), a dynamic permuto lattice of 3 levels (4 .. 16, 2^10 rows) over (xyz,
t), MLPs of 16, geo features 8, 12 coarse samples, 48 rays (some miss the
box), the YAML's losses and Adam settings. Both packages get the same
parameters (``neuralsim_torch.bridge``; the tables moved off their 1e-4
init and the decoders' biases randomised, so that both branches and the
flow vary) and the same draws: the test replays the JAX key tree
(``Trainer.compute_losses`` splits the step's key into (render, uniform,
eikonal), the renderer the render key into (cr, distant); the coarse jitter
is ``uniform(cr key, [N, 96])``; the flow loss's points and times come from
``fold_in(uniform key, 101)`` and ``fold_in`` of that by 1).

Tolerances: outputs rtol 1e-5 / atol 1e-6 (the same float32 operations; the
permuto lattice and the LoTD gather are the JAX math op for op), except
where stated; gradients 1e-4 of each leaf's largest entry (float32 sums in
another order). The steps: loss terms rtol 1e-4; after one and after three
steps every parameter within one lr of JAX's on all but 0.5% of each leaf's
entries and within 6 lr everywhere (the multi-object test's bounds: Adam
with eps 1e-15 steps by lr * sign(g) where a gradient is tiny), each Adam
count equal. JAX's step is compiled once, without XLA's algebraic
simplifier (as tests/test_torch_streetsurf.py does, so that the compiled
step keeps JAX's eager sums), and so are the gradients it is held to.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from neuralsim_tpu.fields import AABBSpace as JaxSpace
from neuralsim_tpu.fields import SimpleSky as JaxSky
from neuralsim_tpu.fields.emernerf import EmerNeRFField as JaxEmerNeRF
from neuralsim_tpu.renderers import SingleVolumeRenderer as JaxRenderer
from neuralsim_tpu.training import Trainer as JaxTrainer
from neuralsim_torch.bridge import load_jax_params, named_jax_leaves
from neuralsim_torch.fields.emernerf import EmerNeRFField
from neuralsim_torch.fields.sky import SimpleSky
from neuralsim_torch.fields.spatial import AABBSpace
from neuralsim_torch.renderers.single_volume import SingleVolumeRenderer
from neuralsim_torch.training.trainer import Trainer
from neuralsim_torch.utils.checkpoint import CheckpointIO

torch.set_num_threads(1)

BOX = ((-1.0, -1.5, -0.5), (2.0, 1.5, 1.0))
N_RAYS, NC, N_FLOW, N_FRAMES = 48, 12, 40, 7
FIELD_KW = dict(static_encoding_cfg={"n_levels": 4, "base_res": 8, "max_res": 32,
                                     "log2_hashmap_size": 10},
                dynamic_permuto_cfg={"n_levels": 3, "base_res": 4, "max_res": 16,
                                     "log2_hashmap_size": 10},
                geo_feat_dim=8, decoder_hidden=16, radiance_hidden=16)
LOSS_CFGS = {"rgb": {"fn_type": "huber", "fn_param": {"delta": 0.1}, "w": 10.0},
             "occupancy_mask": {"w": 0.1}, "flow": {"w": 0.01},
             "dynamic_sparsity": {"w": 0.01}}
ADAM = {"lr": 0.01, "eps": 1.0e-15, "betas": (0.9, 0.99)}
TRAINING_CFGS = {"cr": ADAM, "sky": {"lr": 0.003}}
LOSSES = ("loss_total", "loss_rgb", "loss_mask", "loss_flow", "loss_dynamic_sparsity")
DECOMP = ("sigma_dynamic_cr", "mask_static", "mask_dynamic", "rgb_static", "rgb_dynamic",
          "flow_fwd", "flow_bwd")
RENDER_KEYS = ("rgb_volume", "mask_volume", "depth_volume", "normals_volume", "rgb_sky",
               "samples_cnt") + DECOMP
JAX_STEP_COMPILER_OPTIONS = {"xla_disable_hlo_passes": "algsimp"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _compiled(fn, *args):
    """``fn`` compiled for ``args`` under JAX_STEP_COMPILER_OPTIONS."""
    return jax.jit(fn).lower(*args).compile(compiler_options=JAX_STEP_COMPILER_OPTIONS)


def _close(got, want, rtol=1e-5, atol=1e-6, name=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=name)


def _jax_params(field, seed):
    """JAX's init with the tables moved to trained magnitudes and random
    decoder biases (so that the densities, the dynamic share and the flow
    all vary over the box)."""
    p = jax.tree.map(np.asarray, field.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for enc in ("static_enc", "dyn_enc"):
        if enc in p:
            tbl = p[enc]["table"]
            p[enc]["table"] = rng.normal(0.0, 0.5, tbl.shape).astype(np.float32)
    for dec in ("static_dec", "dyn_dec", "flow_dec"):
        if dec in p:
            for layer in p[dec]["layers"]:
                layer["b"] = rng.normal(0.0, 0.5, layer["b"].shape).astype(np.float32)
    return p


def make_fields(only_dynamic=False, seed=0):
    jf = JaxEmerNeRF(JaxSpace(*BOX), only_dynamic=only_dynamic, **FIELD_KW)
    f = EmerNeRFField(AABBSpace(*BOX), only_dynamic=only_dynamic, **FIELD_KW)
    jp = _jax_params(jf, seed)
    load_jax_params(f, jp)
    return jf, jp, f


@pytest.fixture(scope="module")
def fields():
    return {od: make_fields(od) for od in (False, True)}


def _points(n, seed):
    """Points in the box, a few on its faces."""
    rng = np.random.default_rng(seed)
    lo, hi = np.float32(BOX[0]), np.float32(BOX[1])
    x = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    x[:3, 0], x[3:6, 1], x[6:9, 2] = lo[0], hi[1], lo[2]
    return x


def _rays(n=N_RAYS, seed=1):
    """Rays from around the box through it (the last few pass beside it)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.float32(BOX[0]), np.float32(BOX[1])
    target = lo + (hi - lo) * rng.random((n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = target - 4.0 * d
    o[-4:] += 10.0
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("only_dynamic", [False, True], ids=["both", "only_dynamic"])
@pytest.mark.parametrize("t01", [0.0, 0.37, 1.0])
def test_query_matches_jax(fields, only_dynamic, t01):
    jf, jp, f = fields[only_dynamic]
    x = _points(300, 2)
    tt = np.full(300, t01, np.float32)
    tt[::3] = np.linspace(0, 1, 100, dtype=np.float32)      # times that vary too
    want = jf.query(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jnp.asarray(tt))
    got = f.query(_t(x), _t(tt))
    assert set(got) == set(want) == ({"sigma_dynamic", "feat_dynamic", "flow_fwd", "flow_bwd"}
                                     | (set() if only_dynamic else
                                        {"sigma_static", "feat_static"}))
    for k in want:
        _close(got[k], want[k], name=k)


@pytest.mark.parametrize("only_dynamic", [False, True], ids=["both", "only_dynamic"])
@pytest.mark.parametrize("timed", [False, True], ids=["t0", "cond"])
def test_ray_query_buffer_matches_jax_with_the_same_jitter(fields, only_dynamic, timed):
    jf, jp, f = fields[only_dynamic]
    o, d = _rays()
    key = jax.random.PRNGKey(3)
    cond = np.random.default_rng(4).random((N_RAYS, 1)).astype(np.float32) if timed else None
    want = jf.ray_query(jax.tree.map(jnp.asarray, jp), jnp.asarray(o), jnp.asarray(d),
                        key=key, num_coarse=NC, cond=None if cond is None else jnp.asarray(cond))
    got = f.ray_query(_t(o), _t(d), num_coarse=NC,
                      noise={"coarse": _t(jax.random.uniform(key, (N_RAYS, NC)))},
                      cond=None if cond is None else _t(cond))
    assert set(got) == set(want)
    assert not got["mask"][-4:].any() and got["mask"][:-4].any()
    # the composite kernel (K6) takes contiguous lanes only
    assert all(got[k].is_contiguous() for k in ("t", "mask", "alpha", "rgb", "nablas"))
    for k, v in want.items():
        if k == "details":
            for dk in v:
                _close(got[k][dk], v[dk], name=dk)
        else:
            _close(got[k], v, name=k)


def test_flow_cycle_residual_and_its_gradients_match_jax(fields):
    """The value, and the gradient of its mean into every parameter (the
    static branch's are zero in both: it does not reach the flow)."""
    jf, jp, f = fields[False]
    x = _points(N_FLOW, 5)
    x[-3:] += 0.9                     # moved past the box: the lattice clips
    tt = np.random.default_rng(6).random(N_FLOW).astype(np.float32)
    tt[:2] = [0.0, 1.0]
    jparams = jax.tree.map(jnp.asarray, jp)
    want = jf.flow_cycle_residual(jparams, jnp.asarray(x), jnp.asarray(tt))
    got = f.flow_cycle_residual(_t(x), _t(tt))
    _close(got, want, rtol=1e-5, atol=1e-10)
    assert float(got.detach().max()) > 0
    jg = _compiled(jax.grad(lambda p: jnp.mean(jf.flow_cycle_residual(
        p, jnp.asarray(x), jnp.asarray(tt)))), jparams)(jparams)
    named = dict(f.named_parameters())
    grads = torch.autograd.grad(torch.mean(got), list(named.values()), allow_unused=True)
    wants = named_jax_leaves({"f": jg}, {"f": "f"})
    reached = set()
    for (k, p), g in zip(named.items(), grads):
        w = np.asarray(wants[f"f.{k}"])
        g = torch.zeros_like(p) if g is None else g
        scale = np.abs(w).max()
        if scale == 0:
            assert not g.any(), k
            continue
        reached.add(k.split(".")[0])
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * scale, err_msg=k)
    assert reached == {"dyn_enc", "flow_dec"}


# ---------------------------------------------------------------------------
# the single-volume renderer: the time condition and the decomposition
# ---------------------------------------------------------------------------

def make_renderers(seed=0):
    jf, jp, f = make_fields(False, seed)
    jsky = JaxSky(hidden=8)
    jparams = {"cr": jp, "sky": jax.tree.map(np.asarray, jsky.init(jax.random.PRNGKey(9)))}
    jr = JaxRenderer({"cr": jf, "sky": jsky}, query_cfg={"num_coarse": NC})
    params = nn.ModuleDict({"cr": f, "sky": SimpleSky(hidden=8)})
    load_jax_params(params, jparams)
    r = SingleVolumeRenderer(query_cfg={"num_coarse": NC},
                             param_keys={"cr": "cr", "sky": "sky"})
    return jr, jparams, r, params


@pytest.fixture(scope="module")
def renderers():
    return make_renderers()


@pytest.mark.parametrize("cond_rows", [N_RAYS, 1], ids=["per_ray", "broadcast"])
def test_renderer_with_cond_and_decomposition_matches_jax(renderers, cond_rows):
    jr, jparams, r, params = renderers
    o, d = _rays()
    cond = np.random.default_rng(7).random((cond_rows, 1)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    kcr, _ = jax.random.split(key)
    want = jr.ray_query(jax.tree.map(jnp.asarray, jparams), jnp.asarray(o), jnp.asarray(d),
                        key=key, cond=jnp.asarray(cond))
    got = r.ray_query(params, _t(o), _t(d), cond=_t(cond),
                      noise={"coarse": _t(jax.random.uniform(kcr, (N_RAYS, NC)))})
    for k in RENDER_KEYS:
        _close(got[k], want[k], name=k)
    # the static and dynamic shares sum to the mask
    _close(got["mask_static"] + got["mask_dynamic"], got["mask_volume"].detach().numpy(),
           rtol=0, atol=1e-6)


def test_the_time_reaches_the_dynamic_branch(renderers):
    _, _, r, params = renderers
    o, d = (_t(a) for a in _rays())
    with torch.no_grad():
        r0 = r.ray_query(params, o, d, cond=torch.zeros(N_RAYS, 1))
        r1 = r.ray_query(params, o, d, cond=torch.ones(N_RAYS, 1))
        r_none = r.ray_query(params, o, d)
    assert (r1["mask_dynamic"] - r0["mask_dynamic"]).abs().max() > 1e-4
    assert torch.equal(r_none["mask_dynamic"], r0["mask_dynamic"])


@pytest.mark.parametrize("cond_rows", [N_RAYS, 1], ids=["per_ray", "broadcast"])
def test_render_chunked_gives_one_call_s_outputs(renderers, cond_rows):
    """Chunks of 20 rays (the last one short) against one deterministic
    call: the same per-ray values (the MLPs' products over other row counts
    round alike to 1e-6), the per-sample extras dropped."""
    _, _, r, params = renderers
    o, d = (_t(a) for a in _rays())
    cond = torch.from_numpy(np.random.default_rng(10).random((cond_rows, 1)).astype(np.float32))
    out = r.render_chunked(params, o, d, rayschunk=20, cond=cond)
    with torch.no_grad():
        one = r.ray_query(params, o, d, cond=cond)
    assert "sigma_dynamic_cr" not in out and "vw" not in out
    for k in RENDER_KEYS:
        if k != "sigma_dynamic_cr":
            _close(out[k], one[k].numpy(), name=k)


def test_render_chunked_matches_jax_s_at_one_time(renderers):
    """JAX's ``render_chunked`` (padded chunks under ``lax.map``) at a [1, 1]
    time, as the render tool calls it."""
    jr, jparams, r, params = renderers
    o, d = _rays()
    want = jr.render_chunked(jax.tree.map(jnp.asarray, jparams), jnp.asarray(o),
                             jnp.asarray(d), rayschunk=32, cond=jnp.full((1, 1), 0.6))
    got = r.render_chunked(params, _t(o), _t(d), rayschunk=32, cond=torch.full((1, 1), 0.6))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], name=k)


# ---------------------------------------------------------------------------
# the trainer: the time condition, one step and three
# ---------------------------------------------------------------------------

class _Scene:
    n_frames = N_FRAMES


def make_trainers(seed=0):
    jr, jparams, r, params = make_renderers(seed)
    jt = JaxTrainer(jr, loss_cfgs=LOSS_CFGS, training_cfgs=TRAINING_CFGS,
                    uniform_sample_n=N_FLOW, scene=_Scene())
    t = Trainer(r, loss_cfgs=copy.deepcopy(LOSS_CFGS), training_cfgs=TRAINING_CFGS,
                uniform_sample_n=N_FLOW, scene=_Scene())
    return jt, jparams, t, params


def _batch(seed, fidx=None):
    rng = np.random.default_rng(seed)
    o, d = _rays(seed=seed)
    return {"rays_o": o, "rays_d": d,
            "rays_fidx": (rng.integers(0, N_FRAMES, N_RAYS) if fidx is None
                          else np.full(N_RAYS, fidx)).astype(np.int32),
            "image_rgb": rng.random((N_RAYS, 3)).astype(np.float32),
            "image_occupancy_mask": (rng.random(N_RAYS) < 0.7).astype(np.float32)}


def _noise(key):
    """The port's draws of one JAX step from its key."""
    k_render, k_uniform, _ = jax.random.split(key, 3)
    kcr, _ = jax.random.split(k_render)
    kk = jax.random.fold_in(k_uniform, 101)
    return {"coarse": _t(jax.random.uniform(kcr, (N_RAYS, NC))),
            "flow_points": _t(jax.random.uniform(kk, (N_FLOW, 3))),
            "flow_times": _t(jax.random.uniform(jax.random.fold_in(kk, 1), (N_FLOW,)))}


@pytest.fixture(scope="module")
def trainers():
    return make_trainers()


def test_draw_noise_makes_the_flow_draws(trainers):
    t = trainers[2]
    noise = t.draw_noise(N_RAYS, torch.Generator().manual_seed(0))
    assert noise["coarse"].shape == (N_RAYS, NC)
    assert noise["flow_points"].shape == (N_FLOW, 3) and noise["flow_times"].shape == (N_FLOW,)
    t0 = Trainer(t.renderer, {"flow": {"w": 0.01}}, uniform_sample_n=0)
    assert t0.draw_noise(4, torch.Generator().manual_seed(0))["flow_times"].shape == (1024,)
    t1 = Trainer(t.renderer, {"flow": {"w": 0.01, "n_samples": 17}}, uniform_sample_n=8)
    assert t1.draw_noise(4, torch.Generator().manual_seed(0))["flow_points"].shape == (17, 3)


@pytest.mark.parametrize("fidx", [0, 3, N_FRAMES - 1])
def test_trainer_passes_the_frame_time_as_jax_does(trainers, fidx):
    """The counterpart of JAX's test_trainer_passes_time_cond: cond =
    rays_fidx / (n_frames - 1) reaches the field, so the losses follow JAX's
    at each frame, and another frame gives another loss."""
    jt, jparams, t, params = trainers
    b = _batch(11, fidx)
    key = jax.random.PRNGKey(12)
    jl, jx = jt.compute_losses(jax.tree.map(jnp.asarray, jparams),
                               {k: jnp.asarray(v) for k, v in b.items()}, 0, key, "pixel")
    with torch.no_grad():
        total, ex = t.compute_losses(params, {k: _t(v) for k, v in b.items()}, 0, _noise(key))
    for k in ("loss_rgb", "loss_dynamic_sparsity"):
        _close(ex["losses"][k], jx["losses"][k], rtol=1e-4, atol=0, name=k)
    cond = t.time_cond(params["cr"], {k: _t(v) for k, v in b.items()})
    assert cond.shape == (N_RAYS, 1) and torch.all(cond == np.float32(fidx) / (N_FRAMES - 1))
    if fidx:
        with torch.no_grad():
            t0, _ = t.compute_losses(params, {k: _t(v) for k, v in _batch(11, 0).items()}, 0,
                                     _noise(key))
        assert float(t0) != float(total)


def test_first_step_losses_and_gradients_match_jax(trainers):
    """One step's loss terms (rtol 1e-4) and every gradient leaf (1e-4 of its
    largest entry)."""
    jt, jparams, t, params = trainers
    b = _batch(13)
    key = jax.random.PRNGKey(14)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jp = jax.tree.map(jnp.asarray, jparams)
    (_, jx), jg = _compiled(jax.value_and_grad(
        lambda p: jt.compute_losses(p, jb, 0, key, "pixel"), has_aux=True), jp)(jp)
    total, ex = t.compute_losses(params, {k: _t(v) for k, v in b.items()}, 0, _noise(key))
    assert set(ex["losses"]) == set(jx["losses"]) == set(LOSSES[1:])
    for k, v in jx["losses"].items():
        _close(ex["losses"][k], v, rtol=1e-4, atol=0, name=k)
    named = dict(params.named_parameters())
    grads = torch.autograd.grad(total, list(named.values()), allow_unused=True)
    want = named_jax_leaves(jg, {"cr": "cr", "sky": "sky"})
    for (k, p), g in zip(named.items(), grads):
        w = np.asarray(want[k])
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)
        assert np.abs(w).max() > 0, k


def _adam_count(opt_state, role):
    chain = opt_state.inner_states[role].inner_state
    return int(next(s for s in chain if isinstance(s, optax.ScaleByAdamState)).count)


@pytest.fixture(scope="module")
def runs():
    """Three steps of both packages' ``Trainer.train_step`` from the same
    parameters on the same batches and draws; the state after each."""
    jt, jparams, t, params = make_trainers(seed=1)
    state = t.init_state(params)
    jstate = jt.init_state(None, params=jax.tree.map(jnp.asarray, jparams))
    jstep = type(jt).train_step.__wrapped__
    compiled, out = None, []
    key = jax.random.PRNGKey(15)
    for i in range(3):
        key, k = jax.random.split(key)
        b = _batch(20 + i)
        jb = {name: jnp.asarray(v) for name, v in b.items()}
        state, m = t.train_step(state, {name: _t(v) for name, v in b.items()}, _noise(k))
        if compiled is None:
            compiled = jax.jit(lambda st, bb, kk: jstep(jt, st, bb, kk, "pixel", None, True)) \
                .lower(jstate, jb, k).compile(compiler_options=JAX_STEP_COMPILER_OPTIONS)
        jstate, jm = compiled(jstate, jb, k)
        out.append(({name: float(m[name]) for name in LOSSES + ("step_skipped",)},
                    {name: float(jm[name]) for name in LOSSES + ("step_skipped",)},
                    {k2: v.detach().clone() for k2, v in params.named_parameters()},
                    jax.device_get(jstate.params),
                    {mid: int(opt.count) for mid, opt in state.opt.items()},
                    {mid: _adam_count(jstate.opt_state, mid) for mid in ("cr", "sky")}))
    return out, {mid: float(opt.lr()) for mid, opt in state.opt.items()}


@pytest.mark.parametrize("step", [0, 1, 2])
def test_each_step_s_losses_follow_jax(runs, step):
    got, want = runs[0][step][:2]
    assert got["step_skipped"] == want["step_skipped"] == 0
    for k in LOSSES:
        assert np.isfinite(got[k]) and want[k] != 0, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {step} {k}")


@pytest.mark.parametrize("step", [0, 2], ids=["one_step", "three_steps"])
def test_parameters_and_adam_counts_follow_jax(runs, step):
    (_, _, params, jparams, counts, jcounts), lrs = runs[0][step], runs[1]
    assert counts == jcounts == {"cr": step + 1, "sky": step + 1}
    want = named_jax_leaves(jparams, {"cr": "cr", "sky": "sky"})
    assert set(want) == set(params)
    for k, p in params.items():
        diff = np.abs(p.numpy() - np.asarray(want[k]))
        lr = lrs[k.split(".")[0]]
        assert np.mean(diff > lr) <= 5e-3 and diff.max() <= 6 * lr, (k, float(diff.max()), lr)


def test_checkpoint_round_trips_the_emernerf_state_bit_equal(tmp_path):
    """Two steps, a checkpoint, then a fresh state of other parameters
    loaded from it: every parameter, Adam moment and count, ``it`` and
    ``skips`` the same bits (no occupancy grid: EmerNeRF has none)."""
    _, _, t, params = make_trainers(seed=2)
    state = t.init_state(params)
    gen = torch.Generator().manual_seed(3)
    for i in range(2):
        b = {k: _t(v) for k, v in _batch(30 + i).items()}
        state, _ = t.train_step(state, b, t.draw_noise(N_RAYS, gen))
    io = CheckpointIO(str(tmp_path))
    io.save(state, state.it, tag="final")
    _, _, t2, params2 = make_trainers(seed=3)
    fresh = t2.init_state(params2)
    assert not torch.equal(params2["cr"].dyn_enc.table, params["cr"].dyn_enc.table)
    loaded, _ = io.load(fresh)
    assert loaded.occ is None and loaded.it == state.it == 2
    assert torch.equal(loaded.skips, state.skips)
    for (k, a), (_, b) in zip(params.state_dict().items(), params2.state_dict().items()):
        assert torch.equal(a, b), k
    for mid, opt in state.opt.items():
        for (k, a), b in zip(opt.state_dict().items(), loaded.opt[mid].state_dict().values()):
            assert all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, list) \
                else torch.equal(torch.as_tensor(a), torch.as_tensor(b)), (mid, k)


@pytest.mark.parametrize("extra", [{}, {"aabb": [[-5, -4, -1], [6, 4, 3]]}],
                         ids=["camera_tracks", "aabb"])
@pytest.mark.parametrize("only_dynamic", [False, True], ids=["street", "only_dynamic"])
def test_emernerf_assets_build_jax_s_field_and_box(extra, only_dynamic):
    """``EmerNerfStreet`` and ``EmerNerfStreetOnlyDynamic`` on the demo
    drive: the box (the camera tracks widened by ``extend_size``, or the
    config's ``aabb``), the branches, the ladders and ``query_cfg`` of JAX's
    assets, built from the YAML's model params; without a scene, JAX's
    default box."""
    from neuralsim_tpu.models.assets import EmerNerfStreet as JaxStreet
    from neuralsim_tpu.models.assets import EmerNerfStreetOnlyDynamic as JaxOnlyDynamic
    from neuralsim_tpu.scene import Scene as JaxScene
    from neuralsim_torch.config import load_config
    from neuralsim_torch.dataio.waymo_demo import demo_sequence
    from neuralsim_torch.models.assets import EmerNerfStreet, asset_class
    from neuralsim_torch.scene import Scene
    mp = {**load_config("configs/waymo_emernerf.yaml")["assetbank_cfg"]["Street"]
          ["model_params"], **extra}
    scenario = demo_sequence().get_scenario()
    jcls = JaxOnlyDynamic if only_dynamic else JaxStreet
    port_cls = asset_class(f"neuralsim_tpu.models.assets.{jcls.__name__}")
    assert issubclass(port_cls, EmerNerfStreet) and port_cls.only_dynamic == only_dynamic
    for scene_of in ((JaxScene.load_from_scenario, Scene.load_from_scenario), (None, None)):
        ja, pa = jcls(dict(mp)), port_cls(dict(mp))
        ja.populate(scene_of[0](scenario) if scene_of[0] else None)
        pa.populate(scene_of[1](scenario) if scene_of[1] else None)
        jf, f = ja.field, pa.field
        np.testing.assert_allclose(f.space.aabb_min.numpy(), np.asarray(jf.space.aabb_min),
                                   atol=1e-6)
        np.testing.assert_allclose(f.space.aabb_max.numpy(), np.asarray(jf.space.aabb_max),
                                   atol=1e-6)
        assert pa.query_cfg == ja.query_cfg == {"num_coarse": 96}
        assert (f.only_dynamic, f.with_flow) == (jf.only_dynamic, jf.with_flow)
        assert hasattr(f, "static_enc") != only_dynamic
        assert f.dyn_enc.levels == [tuple(lv) for lv in jf.dyn_enc.levels]
        assert f.dyn_enc.table_size == jf.dyn_enc.table_size
        if not only_dynamic:
            assert [(s.res, s.typ, s.size) for s in f.static_enc.specs] == \
                [(s.res, s.typ, s.size) for s in jf.static_enc.specs]
        jp = jax.tree.map(np.asarray, jf.init(jax.random.PRNGKey(0)))
        load_jax_params(f, jp)               # the same tree, leaf for leaf
