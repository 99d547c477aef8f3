"""Port parity for the stacked CP lines (kernel K14) and its backward: the
plain version against the JAX package's ``LoTDEncoding._cp_stacked_lines``
on the CPU, and the static plan the CUDA kernels read (the taps, the level
metadata, the backward's CSR of taps by source row) against a
dense scatter in numpy and a replay of the kernels' arithmetic; the backward's work items (which
warp sums which entries, with how many lanes an entry) cover the table once,
and the backward summed in their order (a fixed-order split of each long
row's taps) agrees with JAX's VJP.

The ladder has a level of R 1 (both taps on its one row: the upper tap
clamped), one of R 2, one of R 37 (F 5) and two of R_max = 64, beside a
dense level, so the CP segments sit at offsets past a grid level.

Tolerances: the plain forward is JAX's op for op, so run op by op JAX gives
the same bits (exact); under jit XLA may contract the lerp into an FMA
(1e-6). Gradients are sums of at most 2 R_max / R terms a table entry in
another order than JAX's scatter-add: within 1e-6 of the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_tpu.fields.encodings.lotd import make_lotd as jax_make_lotd
from neuralsim_torch.fields.encodings.lotd import (CP_LINES_MAX_ITEMS, CP_LINES_ZERO_CHUNK,
                                                   CpLinesPlan, cp_lines_items, cp_lines_plan,
                                                   cp_lines_work, lotd_cp_lines,
                                                   lotd_cp_lines_bwd, lotd_cp_lines_bwd_plain,
                                                   lotd_cp_lines_plain, make_lotd)

torch.set_num_threads(1)

LADDER = {"levels": [(4, 2, "dense"), (1, 3, "cp"), (2, 4, "cp"), (37, 5, "cp"), (64, 2, "cp"),
                     (64, 3, "cp")]}
GRAD_REL = 1e-6


@pytest.fixture(scope="module")
def pair():
    jenc = jax_make_lotd(LADDER)
    rng = np.random.default_rng(0)
    table = (np.asarray(jenc.init(jax.random.PRNGKey(0))["table"])
             + rng.normal(0.0, 0.3, jenc.total_params)).astype(np.float32)
    penc = make_lotd(LADDER)
    with torch.no_grad():
        penc.table.copy_(torch.from_numpy(table))
    g = rng.normal(0.0, 1.0, (3, penc.cp_out_dim, penc.cp_rmax)).astype(np.float32)
    return jenc, penc, table, g


def _dense_taps(plan: CpLinesPlan):
    """Each level's [R, R_max] matrix of tap weights, scattered in numpy."""
    out = []
    for k, (_, _, R, _, _, _) in enumerate(plan.levels.tolist()):
        lo, w = plan.lo[k].numpy(), plan.w[k].numpy()
        m = np.zeros((R, lo.size), np.float32)
        np.add.at(m, (lo, np.arange(lo.size)), np.float32(1.0) - w)
        np.add.at(m, (np.minimum(lo + 1, R - 1), np.arange(lo.size)), w)
        out.append(m)
    return out


def test_the_ladder_matches_jax(pair):
    jenc, penc, _, _ = pair
    assert [(s.res, s.n_feats, s.typ, s.offset) for s in penc.specs] == \
        [(s.res, s.n_feats, s.typ, s.offset) for s in jenc.specs]
    assert penc.cp_stacked and penc.cp_rmax == 64 and penc.cp_out_dim == 17


def test_plain_cp_lines_match_jax(pair):
    jenc, penc, table, _ = pair
    got = penc.cp_stacked_lines().detach().numpy()
    with jax.disable_jit():
        eager = np.asarray(jenc._cp_stacked_lines(jnp.asarray(table)))
    jitted = np.asarray(jax.jit(jenc._cp_stacked_lines)(jnp.asarray(table)))
    assert got.shape == (3, 17, 64) and np.array_equal(got, eager)
    np.testing.assert_allclose(got, jitted, rtol=1e-6, atol=1e-6)
    # the wrapper takes the plain version on the CPU
    plan = penc.cp_lines_plan()
    f32, bf16 = lotd_cp_lines(penc.table.detach(), plan)
    assert torch.equal(f32, torch.from_numpy(got))
    assert torch.equal(bf16, torch.from_numpy(got).to(torch.bfloat16))


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_plain_cp_lines_vjp_matches_jax(pair, layout):
    """The table's gradient from the lines' cotangent, contiguous [3, F, R]
    and as the view of a [3, R, F] buffer that K1's backward hands back."""
    jenc, penc, table, g = pair
    _, vjp = jax.vjp(jenc._cp_stacked_lines, jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    gt = torch.from_numpy(g)
    if layout == "transposed":
        gt = gt.transpose(1, 2).contiguous().transpose(1, 2)
        assert not gt.is_contiguous()
    plan = penc.cp_lines_plan()
    got = lotd_cp_lines_bwd_plain(gt, penc.table.numel(), plan).numpy()
    assert np.array_equal(got, lotd_cp_lines_bwd(gt, penc.table.numel(), plan).numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * np.abs(want).max())
    # through the encoding under autograd
    penc.table.grad = None
    (penc.cp_stacked_lines() * gt).sum().backward()
    np.testing.assert_allclose(penc.table.grad.numpy(), want, rtol=0,
                               atol=GRAD_REL * np.abs(want).max())
    grid = slice(0, penc.specs[1].offset)        # the dense level gets nothing
    assert not np.any(got[grid]) and np.all(np.abs(got[penc.specs[1].offset:]) > 0)


def test_plan_csr_matches_a_dense_scatter(pair):
    _, penc, _, _ = pair
    plan = penc.cp_lines_plan()
    cp = [s for s in penc.specs if s.typ == "cp"]
    assert plan.levels.tolist() == [
        [sum(3 * c.res * c.n_feats for c in cp[:k]), s.offset, s.res, s.n_feats,
         sum(c.n_feats for c in cp[:k]), sum(c.res for c in cp[:k])] for k, s in enumerate(cp)]
    assert plan.n_cols == sum(s.n_feats for s in cp) == penc.cp_out_dim
    assert plan.n_entries == sum(3 * s.res * s.n_feats for s in cp)
    rowptr, tj, tw = plan.rowptr.numpy(), plan.tap_j.numpy(), plan.tap_w.numpy()
    assert rowptr[0] == 0 and rowptr[-1] == tj.size == 2 * len(cp) * 64
    assert np.all(np.diff(rowptr) >= 0)
    for k, m in enumerate(_dense_taps(plan)):
        first = plan.levels[k, 5].item()
        csr = np.zeros_like(m)
        for r in range(m.shape[0]):
            span = slice(rowptr[first + r], rowptr[first + r + 1])
            assert np.all(np.diff(tj[span]) >= 0)           # by position, lower tap first
            np.add.at(csr[r], tj[span], tw[span])
        assert np.array_equal(csr, m)
    # R 1: every position reads its one row twice, weights 1 and 0
    r1 = plan.levels[0].tolist()
    assert r1[2] == 1 and rowptr[r1[5] + 1] - rowptr[r1[5]] == 128


def test_kernels_arithmetic_replayed_in_numpy(pair):
    """The forward kernel's lerp as its blocks take it, a level and an axis
    from the level metadata, a position's F features from its two table rows
    (float32 operations without FMA, as __fmul_rn etc.), is the plain version
    bit for bit, and so are its bf16 lines; the backward's walk of the CSR, a
    table entry at a time, is the plain backward within GRAD_REL."""
    _, penc, table, g = pair
    plan = penc.cp_lines_plan()
    out = np.empty((3, plan.n_cols, plan.lo.shape[1]), np.float32)
    for k, (_, offset, R, F, col, _) in enumerate(plan.levels.tolist()):
        lo, w = plan.lo[k].numpy(), plan.w[k].numpy()[:, None]
        for a in range(3):
            seg = table[offset + a * R * F:offset + (a + 1) * R * F].reshape(R, F)
            l0, l1 = seg[lo], seg[np.minimum(lo + 1, R - 1)]            # [R_max, F] rows
            out[a, col:col + F] = (l0 * (np.float32(1.0) - w) + l1 * w).T
    f32, bf16 = lotd_cp_lines_plain(torch.from_numpy(table), plan)
    assert np.array_equal(out, f32.numpy())
    assert torch.equal(bf16, torch.from_numpy(out).to(torch.bfloat16))
    d = np.zeros(table.size, np.float32)
    rowptr, tj, tw = plan.rowptr.numpy(), plan.tap_j.numpy(), plan.tap_w.numpy()
    for first, offset, R, F, col, row in plan.levels.tolist():
        for local in range(3 * R * F):
            f, r, a = local % F, (local // F) % R, local // (F * R)
            span = slice(rowptr[row + r], rowptr[row + r + 1])
            d[offset + local] = np.sum(g[a, col + f, tj[span]] * tw[span], dtype=np.float32)
    want = lotd_cp_lines_bwd_plain(torch.from_numpy(g), table.size, plan).numpy()
    np.testing.assert_allclose(d, want, rtol=0, atol=GRAD_REL * np.abs(want).max())


def test_plan_of_a_single_level_at_r_max():
    plan = cp_lines_plan([(16, 2, 10)], 16)
    assert plan.lo.tolist()[0][-1] == 14 and plan.w[0, -1].item() == 1.0
    assert plan.levels.tolist() == [[0, 10, 16, 2, 0, 0]] and plan.n_entries == 96


def _items(plan, taps_a_lane):
    return cp_lines_items(plan.levels.tolist(), plan.rowptr.numpy(), plan.n_table, taps_a_lane)


@pytest.mark.parametrize("taps_a_lane", [None, 1, 4, 16], ids=["plan", "1", "4", "16"])
def test_plan_items_cover_the_table_once(pair, taps_a_lane):
    """Every CP entry is summed by exactly one lane group, every other float
    of the table is zeroed by exactly one item; each level's G lanes an entry
    is the least power of two that leaves at most ``taps_a_lane`` of its
    longest row's taps (rowptr) to a lane, 32 at most, longest rows first;
    the plan's own list is the first that fits CP_LINES_MAX_ITEMS."""
    _, penc, _, _ = pair
    plan = penc.cp_lines_plan()
    assert plan.n_table == penc.table.numel()
    if taps_a_lane is None:
        taps_a_lane, items = cp_lines_work(plan.levels.tolist(), plan.rowptr.numpy(),
                                           plan.n_table)
        assert np.array_equal(items, plan.items.numpy())
        assert taps_a_lane == 1 and items.shape[0] <= CP_LINES_MAX_ITEMS
    else:
        items = _items(plan, taps_a_lane)
    assert items.dtype == np.int32 and items.shape[1] == 4
    rowptr, levels = plan.rowptr.numpy(), plan.levels.tolist()
    hits = np.zeros(plan.n_table, np.int64)
    gs = []
    for k, first, G, pad in items.tolist():
        assert pad == 0
        if k < 0:
            assert 0 < G <= CP_LINES_ZERO_CHUNK
            hits[first:first + G] += 1
            continue
        _, offset, R, F, _, row = levels[k]
        taps = np.diff(rowptr[row:row + R + 1]).max()
        assert G & (G - 1) == 0 and (G == 32 or G * taps_a_lane >= taps)
        assert G == 1 or (G // 2) * taps_a_lane < taps
        local = np.arange(first, min(first + 32 // G, 3 * R * F))
        assert first % (32 // G) == 0 and local.size
        assert np.all((local // F) % R < R) and np.all(row + (local // F) % R < row + R)
        hits[offset + local] += 1
        gs.append(G)
    assert np.all(hits == 1)
    assert gs == sorted(gs, reverse=True) and len(set(gs)) > 1
    # the zero items follow the CP items and cover the dense level
    zero = items[:, 0] < 0
    assert zero.any() and not np.any(np.diff(zero.astype(int)) < 0)
    assert hits[:penc.specs[1].offset].sum() == penc.specs[1].offset


def _bwd_in_plan_order(g, plan, items):
    """K14's backward replayed in numpy float32, item by item: lane (gg, e)
    sums taps gg, gg + G, ... of entry e from the left, then the shuffle
    tree (lane l adds lane l + d for d = 16 .. 32 / G; a lane past the warp
    adds its own value)."""
    d = np.full(plan.n_table, np.nan, np.float32)
    rowptr, tj, tw = plan.rowptr.numpy(), plan.tap_j.numpy(), plan.tap_w.numpy()
    levels = plan.levels.tolist()
    for k, first, G, _ in items.tolist():
        if k < 0:
            d[first:first + G] = 0.0
            continue
        _, offset, R, F, col, row = levels[k]
        E = 32 // G
        s = np.zeros(32, np.float32)
        for lane in range(32):
            gg, e = divmod(lane, E)
            local = first + e
            if local >= 3 * R * F:
                continue
            f, r, a = local % F, (local // F) % R, local // (F * R)
            for t in range(rowptr[row + r] + gg, rowptr[row + r + 1], G):
                s[lane] = s[lane] + g[a, col + f, tj[t]] * tw[t]
        dd = 16
        while dd >= E:
            s = np.concatenate([s[:32 - dd] + s[dd:], s[32 - dd:] + s[32 - dd:]])
            dd //= 2
        n = min(E, 3 * R * F - first)
        d[offset + first:offset + first + n] = s[:n]
    return d


@pytest.mark.parametrize("taps_a_lane", [1, 4, 16])
def test_backward_in_the_plan_order_matches_jax(pair, taps_a_lane):
    """The table gradient summed in the work items' order (the kernel's) is
    within GRAD_REL of JAX's VJP, every float of the table written."""
    jenc, penc, table, g = pair
    _, vjp = jax.vjp(jenc._cp_stacked_lines, jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    plan = penc.cp_lines_plan()
    got = _bwd_in_plan_order(g, plan, _items(plan, taps_a_lane))
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * np.abs(want).max())
    assert not np.any(got[:penc.specs[1].offset])


def test_plan_table_size_and_gaps():
    """A plan's table reaches past its last CP level where asked: the floats
    before, between and after the CP segments are zero items."""
    plan = cp_lines_plan([(3, 2, 5), (8, 1, 40)], 8, 100)
    assert plan.n_table == 100 and plan.n_entries == 18 + 24
    zeros = [(f, c) for k, f, c, _ in plan.items.tolist() if k < 0]
    assert zeros == [(0, 5), (23, 17), (64, 36)]
    assert cp_lines_plan([(3, 2, 5), (8, 1, 40)], 8).n_table == 64


def test_plan_takes_fewer_lanes_an_entry_on_a_large_table():
    """A stacked encoding as wide as the bench model's (12 levels of F 8 to
    R_max 1,024) takes the first taps a lane whose work list fits
    CP_LINES_MAX_ITEMS warps; one lane an entry would need ~22k."""
    levels = [(int(16 * 1.4 ** k) if k < 11 else 1024, 8, 0) for k in range(12)]
    off = 0
    for k, (R, F, _) in enumerate(levels):
        levels[k] = (R, F, off)
        off += 3 * R * F
    plan = cp_lines_plan(levels, 1024)
    taps, items = cp_lines_work(plan.levels.tolist(), plan.rowptr.numpy(), plan.n_table)
    assert taps > 1 and items.shape[0] <= CP_LINES_MAX_ITEMS < _items(plan, taps // 2).shape[0]
    assert np.array_equal(items, plan.items.numpy())
