"""K11's cluster algorithm (``csrc/pair_compact.cu``) replayed in numpy
against the JAX package's argsort lines, on the CPU.

The replay takes the kernel's steps with the kernel's split of the rays
(``pair_cluster_layout``): words of 32 rays, each (instance, word) one ballot
word (a uint32 bit mask), its popcount, each CTA's prefix of every
instance's words, the per-instance counts of the earlier CTAs (what a CTA
reads from the others' shared memory) and H_k, then a lane's rank as the
word's prefix + popcount(word & lanemask_lt) and each pair's place and slot
by the closed form in the kernel's header. The JAX side is the selection
(neuralsim_tpu/renderers/buffer_compose.py:185-193) and the slot assignment
(:296-303), as tests/test_torch_pair_compact.py runs them, jitted once per
shape and budget. Exact: these are integers.

Cases: K 1, 2, 8, 17 and 4096 at small N, none a multiple of 32 or of a
CTA's tile, so the last word and the last CTA are ragged; ragged random masks
(an instance that hits nothing), every pair a hit, no hit, and rays that
cross more than M = 4 boxes; budgets of half the rays, all the rays and,
where small, every pair.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralsim_torch.ops.pair_compact import (PAIR_CLUSTER_MAX, pair_budget,
                                              pair_cluster_layout, pair_compact_plain)

M = 4
# (K, N): C CTAs of WC words each, the last ones short
SHAPES = ((1, 45), (2, 2047), (8, 333), (17, 97), (4096, 33))
MASKS = ("ragged", "every pair a hit", "no hit", "more than M boxes")


@functools.lru_cache(maxsize=None)
def _jax_lines(K, N, Bg, m):
    """The JAX package's lines for a [K, N] mask, one compile a shape and
    budget: (order, hit_c, slot index of each selected row)."""

    def lines(hit):
        rank = jnp.cumsum(hit, axis=1) - 1
        keyv = jnp.where(hit, rank * K + jnp.arange(K, dtype=jnp.int32)[:, None],
                         jnp.int32(K * N))
        order = jnp.argsort(keyv.reshape(-1))[:Bg]
        hit_c = jnp.take(keyv.reshape(-1), order) < K * N
        r_for_slot = jnp.where(hit_c, order % N, N)
        perm = jnp.argsort(r_for_slot)
        r_s = r_for_slot[perm]
        slot = jnp.arange(Bg) - jnp.searchsorted(r_s, r_s, side="left")
        flat_idx = jnp.where((r_s < N) & (slot < m), r_s * m + slot, N * m)
        return order, hit_c, jnp.zeros_like(flat_idx).at[perm].set(flat_idx)

    return jax.jit(lines)


def _mask(kind, K, N, seed):
    rng = np.random.default_rng(seed)
    if kind == "every pair a hit":
        return np.ones((K, N), bool)
    if kind == "no hit":
        return np.zeros((K, N), bool)
    hit = rng.random((K, N)) < np.linspace(0.02, 0.9, K)[:, None]
    if K > 1:
        hit[0] = False                                 # an instance that hits nothing
    if kind == "more than M boxes":
        hit[:, ::3] = True                             # every instance on every third ray
    return hit


def _popc(words):
    return np.bitwise_count(words).astype(np.int64)


def cluster_replay(hit, Bg, m):
    """K11's cluster launch in numpy -> (order, hit_c, slot_idx), and the
    place of every pair (a permutation of [0, K N) when the closed form
    holds)."""
    K, N = hit.shape
    C, WC, _ = pair_cluster_layout(K, N)
    NW = -(-N // 32)
    bits = np.zeros((K, NW * 32), bool)
    bits[:, :N] = hit
    # 1. a ballot an (instance, word): bit l is lane l's ray
    words = (bits.reshape(K, NW, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    pre = np.zeros((K, NW), np.int64)
    cnt = np.zeros((C, K), np.int64)
    for c in range(C):
        tile = slice(c * WC, min((c + 1) * WC, NW))
        counts = _popc(words[:, tile])
        # 2. each word's hits before it in the tile, the tile's hits
        pre[:, tile] = np.cumsum(counts, axis=1) - counts
        cnt[c] = counts.sum(1)
    # 3. what each CTA reads from the cluster: the earlier CTAs' counts, H
    base = np.cumsum(cnt, axis=0) - cnt                # [C, K]
    H = cnt.sum(0)
    before = np.concatenate([[0], np.cumsum(H)])
    T = before[K]
    # 4. a lane's rank: hits of its instance before its ray
    r = np.arange(NW * 32)
    w, lane = r // 32, r % 32
    below = ((np.uint64(1) << lane.astype(np.uint64)) - np.uint64(1)).astype(np.uint32)
    j = base[w // WC].T + pre[:, w] + _popc(words[:, w] & below)     # [K, NW * 32]
    j, r = j[:, :N], r[:N]
    k = np.arange(K)[:, None]
    # the closed form, its sums over instances q as tables over the rank
    ranks = np.arange(N + 1)
    at_most = np.minimum(H[None, :], ranks[:, None]).sum(1)                   # sum_q min(H_q, j)
    above = np.concatenate([np.zeros((N + 1, 1), np.int64),
                            np.cumsum(H[None, :] > ranks[:, None], axis=1)], 1)  # q < k, H_q > j
    pos = np.where(hit, at_most[j] + above[j, k], T + k * N + r - before[:K, None] - j)
    sel = pos < Bg
    order = np.full(Bg, -1, np.int64)
    hit_c = np.zeros(Bg, bool)
    order[pos[sel]] = (k * N + r)[sel]
    hit_c[pos[sel]] = hit[sel]
    slot_idx = np.full(Bg, N * m, np.int64)
    kk, rr = np.nonzero(sel & hit)
    jj = j[kk, rr]
    slot = np.zeros_like(jj)
    for q in range(K):        # the kernel's ballot of each instance at the same rays
        jq = j[q, rr]
        slot += hit[q, rr] & ((jq < jj) | ((jq == jj) & (q < kk)))
    slot_idx[pos[kk, rr]] = np.where(slot < m, rr * m + slot, N * m)
    return order, hit_c, slot_idx, pos


def test_layout_splits_the_words_over_at_most_sixteen_ctas():
    """Every CTA takes words, the last one the rest; C = 1 where N <= 32."""
    for K, N in SHAPES + ((8, 4096), (2, 200_003), (3, 32), (3, 33)):
        C, WC, smem = pair_cluster_layout(K, N)
        NW = -(-N // 32)
        assert 1 <= C <= PAIR_CLUSTER_MAX and (C - 1) * WC < NW <= C * WC
        assert (WC - 1) * PAIR_CLUSTER_MAX < NW         # the least tile the CTAs cover
        assert smem == (2 * K * WC + 4 * K + 1) * 4
        assert (C == 1) == (N <= 32)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("K,N", SHAPES, ids=[f"K{k}-N{n}" for k, n in SHAPES])
def test_cluster_replay_matches_jax(K, N, kind):
    hit = _mask(kind, K, N, K + N)
    budgets = {pair_budget(K, N, 0.5), pair_budget(K, N, 1.0)}
    if K * N <= 20_000:
        budgets.add(K * N)
    for Bg in sorted(budgets):
        order, hit_c, slot_idx, pos = cluster_replay(hit, Bg, M)
        assert np.array_equal(np.sort(pos.ravel()), np.arange(K * N))   # one place a pair
        want = [np.asarray(v) for v in _jax_lines(K, N, Bg, M)(jnp.asarray(hit))]
        assert np.array_equal(order, want[0]), f"order, Bg={Bg}"
        assert np.array_equal(hit_c, want[1]), f"hit_c, Bg={Bg}"
        assert np.array_equal(slot_idx, want[2]), f"slot_idx, Bg={Bg}"
        # the plain version (the CPU path) agrees too
        got = pair_compact_plain(torch.from_numpy(hit), Bg, M)
        assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    if kind == "more than M boxes":
        assert (hit.sum(0) > M).any() or K <= M
