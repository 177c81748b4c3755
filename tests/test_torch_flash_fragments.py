"""The fragment index math of the flash kernels, mirrored in numpy.

The CUDA kernels (ops/csrc/flash_fwd.cu, flash_bwd.cu) run only on the
card, so their lane-level index math is checked here instead. This file
mirrors, over the 32 lanes of a warp (g = lane / 4, t = lane % 4):

  * the fragment maps of ops/csrc/flash_mma.cuh — `load_a`, `load_b_nk`,
    `load_b_kn` and `acc_as_a` — as the header writes them;
  * the m16n8k8 (tf32) operand and accumulator layouts of the PTX ISA
    that those maps feed (`mma` below);
  * the forward's online-softmax step in the accumulator layout: the
    per-n-tile skip (`any_visible`, `all_visible` in flash_common.cuh),
    the row maximum reduced over the four lanes of a quad before any exp
    (`quad_max`), the dead-row rule, and l kept as a per-lane partial sum
    reduced over the quad at the end (`quad_sum`).

Composing 16 rows x 32-key chunks through these maps must give what the
plain recurrence gives, and a lane-local maximum must give a wrong O. The
mirror must change with the header: a map changed in flash_mma.cuh and not
here no longer tests the kernel. Everything is float64, so an index error
shows as an O(1) difference and rounding stays near 1e-15.
"""

import numpy as np
import pytest

NEG_INF = -1e30
LANE = np.arange(32)
G = LANE // 4
T = LANE % 4


# -- flash_mma.cuh, as written there ----------------------------------------


def load_a(tile, mul=1.0):
    """A from 16 rows x 8 columns: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
    a3 (g+8, t+4), each times `mul`. Returns [32 lanes, 4]."""
    return np.stack([tile[G, T], tile[G + 8, T], tile[G, T + 4],
                     tile[G + 8, T + 4]], axis=1) * mul


def load_b_nk(tile):
    """B(k, n) = tile[n][k], as K^T in S = Q K^T: (tile[g][t],
    tile[g][t+4]). Returns [32, 2]."""
    return np.stack([tile[G, T], tile[G, T + 4]], axis=1)


def load_b_kn(tile):
    """B(k, n) = tile[k][n] with the permuted k of acc_as_a: rows 2t and
    2t+1, column g, as V in O += P V."""
    return np.stack([tile[2 * T, G], tile[2 * T + 1, G]], axis=1)


def acc_as_a(c):
    """An accumulator as the next product's A operand: (c0, c2, c1, c3)."""
    return c[:, [0, 2, 1, 3]]


# -- the PTX ISA's mma.sync.m16n8k8 layouts ----------------------------------


def _a_matrix(a):
    m = np.full((16, 8), np.nan)
    m[G, T], m[G + 8, T], m[G, T + 4], m[G + 8, T + 4] = a.T
    return m


def _b_matrix(b):
    m = np.full((8, 8), np.nan)
    m[T, G], m[T + 4, G] = b.T
    return m


def _c_matrix(c):
    m = np.full((16, 8), np.nan)
    m[G, 2 * T], m[G, 2 * T + 1], m[G + 8, 2 * T], m[G + 8, 2 * T + 1] = c.T
    return m


def _c_lanes(m):
    return np.stack([m[G, 2 * T], m[G, 2 * T + 1], m[G + 8, 2 * T],
                     m[G + 8, 2 * T + 1]], axis=1)


def mma(c, a, b):
    """d = a b + c on per-lane fragments, through the matrices they
    stand for."""
    return _c_lanes(_a_matrix(a) @ _b_matrix(b) + _c_matrix(c))


# -- flash_common.cuh and flash_fwd.cu ---------------------------------------


def any_visible(r_lo, r_hi, c_lo, c_hi, causal, window):
    if causal and r_hi < c_lo:
        return False
    return not (window and r_lo - c_hi >= window)


def all_visible(r_lo, r_hi, c_lo, c_hi, causal, window):
    if causal and r_lo < c_hi:
        return False
    return not (window and r_hi - c_lo >= window)


def visible(q_pos, k_pos, causal, window):
    ok = np.ones(np.broadcast(q_pos, k_pos).shape, bool)
    if causal:
        ok &= q_pos >= k_pos
    if window:
        ok &= q_pos - k_pos < window
    return ok


def quad_max(x):
    x = np.maximum(x, x[LANE ^ 1])
    return np.maximum(x, x[LANE ^ 2])


def quad_sum(x):
    x = x + x[LANE ^ 1]
    return x + x[LANE ^ 2]


def warp_forward(q, k, v, scale, q_pos0, k_pos0, causal, window,
                 reduce_max=quad_max):
    """One warp's 16 rows over the keys of k and v in chunks of 4 n-tiles
    of 8 keys, as flash_fwd.cu's chunk loop. Returns (O [16, D]
    unnormalized, l [16], m [16])."""
    dim = q.shape[1]
    o = np.zeros((32, dim // 8, 4))
    m_a = np.full(32, NEG_INF)
    m_b = np.full(32, NEG_INF)
    l_a = np.zeros(32)
    l_b = np.zeros(32)
    row = np.stack([G, G, G + 8, G + 8], axis=1)  # each c's row
    wq_lo = q_pos0
    for key0 in range(0, k.shape[0], 32):
        live, full = [], []
        for n in range(4):
            c_lo = k_pos0 + key0 + 8 * n
            live.append(any_visible(wq_lo, wq_lo + 15, c_lo, c_lo + 7, causal, window))
            full.append(all_visible(wq_lo, wq_lo + 15, c_lo, c_lo + 7, causal, window))
        if not any(live):
            continue
        s = np.zeros((4, 32, 4))
        for ks in range(dim // 8):
            aq = load_a(q[:, 8 * ks:8 * ks + 8], scale)
            for n in range(4):
                if live[n]:
                    k_tile = k[key0 + 8 * n:key0 + 8 * n + 8, 8 * ks:8 * ks + 8]
                    s[n] = mma(s[n], aq, load_b_nk(k_tile))
        for n in range(4):
            key = key0 + 8 * n + 2 * T[:, None] + np.array([0, 1, 0, 1])
            ok = live[n] & (full[n] | visible(q_pos0 + row, k_pos0 + key,
                                              causal, window))
            s[n] = np.where(ok, s[n], NEG_INF)
        mn_a = np.maximum(m_a, reduce_max(s[:, :, :2].max(axis=(0, 2))))
        mn_b = np.maximum(m_b, reduce_max(s[:, :, 2:].max(axis=(0, 2))))
        alpha_a, alpha_b = np.exp(m_a - mn_a), np.exp(m_b - mn_b)
        dead_a, dead_b = mn_a == NEG_INF, mn_b == NEG_INF
        p = np.empty_like(s)
        p[:, :, :2] = np.where(dead_a[:, None], 0.0, np.exp(s[:, :, :2] - mn_a[:, None]))
        p[:, :, 2:] = np.where(dead_b[:, None], 0.0, np.exp(s[:, :, 2:] - mn_b[:, None]))
        l_a = l_a * alpha_a + p[:, :, :2].sum(axis=(0, 2))
        l_b = l_b * alpha_b + p[:, :, 2:].sum(axis=(0, 2))
        m_a, m_b = mn_a, mn_b
        o *= np.stack([alpha_a, alpha_a, alpha_b, alpha_b], axis=1)[:, None]
        for n in range(4):
            if not live[n]:
                continue
            ap = acc_as_a(p[n])
            for d in range(dim // 8):
                v_tile = v[key0 + 8 * n:key0 + 8 * n + 8, 8 * d:8 * d + 8]
                # mma_split_add: a fresh chain added into O.
                o[:, d] += mma(np.zeros((32, 4)), ap, load_b_kn(v_tile))
    out = np.concatenate([_c_matrix(o[:, d]) for d in range(dim // 8)], axis=1)
    l_a, l_b = quad_sum(l_a), quad_sum(l_b)
    l_rows = np.concatenate([l_a[T == 0], l_b[T == 0]])
    m_rows = np.concatenate([m_a[T == 0], m_b[T == 0]])
    return out, l_rows, m_rows


def plain_forward(q, k, v, scale, q_pos0, k_pos0, causal, window, step=32):
    """The plain recurrence (ops/flash_attention.py: _forward_plain) over
    steps of `step` keys."""
    o = np.zeros(q.shape)
    l = np.zeros(q.shape[0])
    m = np.full(q.shape[0], NEG_INF)
    q_pos = q_pos0 + np.arange(q.shape[0])
    for c0 in range(0, k.shape[0], step):
        s = (q * scale) @ k[c0:c0 + step].T
        k_pos = k_pos0 + c0 + np.arange(s.shape[1])
        s = np.where(visible(q_pos[:, None], k_pos[None], causal, window), s, NEG_INF)
        m_new = np.maximum(m, s.max(axis=1))
        alpha = np.exp(m - m_new)
        p = np.where((m_new == NEG_INF)[:, None], 0.0, np.exp(s - m_new[:, None]))
        l = l * alpha + p.sum(axis=1)
        o = o * alpha[:, None] + p @ v[c0:c0 + step]
        m = m_new
    return o, l, m


def _operands(seed, dim=32, keys=64, spread=3.0):
    rng = np.random.RandomState(seed)
    q = rng.randn(16, dim) * spread
    return q, rng.randn(keys, dim), rng.randn(keys, dim)


class TestLayouts:
    def test_each_fragment_covers_its_matrix_once(self):
        """The ISA layouts as mirrored: every element of A, B and C is
        held by exactly one (lane, slot)."""
        for build, shape, slots in ((_a_matrix, (16, 8), 4),
                                    (_b_matrix, (8, 8), 2),
                                    (_c_matrix, (16, 8), 4)):
            ids = np.arange(32 * slots, dtype=float).reshape(32, slots)
            m = build(ids)
            assert m.shape == shape
            assert sorted(m.ravel().astype(int)) == list(range(32 * slots))

    def test_s_and_p_v_products_through_the_maps(self):
        """S = Q K^T through load_a/load_b_nk, then O = S V through
        acc_as_a/load_b_kn: the permuted k of the second product lines up
        with the accumulator's columns."""
        rng = np.random.RandomState(0)
        q, k, v = rng.randn(16, 8), rng.randn(8, 8), rng.randn(8, 8)
        s = mma(np.zeros((32, 4)), load_a(q, 0.5), load_b_nk(k))
        np.testing.assert_allclose(_c_matrix(s), 0.5 * q @ k.T, rtol=1e-13)
        o = mma(np.zeros((32, 4)), acc_as_a(s), load_b_kn(v))
        np.testing.assert_allclose(_c_matrix(o), 0.5 * q @ k.T @ v, rtol=1e-12)


    def test_dq_products_at_d16_through_the_maps(self):
        """flash_bwd.cu's dq at D = 16: S = Q K^T over KD = 2 k-steps of
        load_a/load_b_nk, then dQ = S K through acc_as_a and load_b_kn
        over KD = 2 n-tiles of 8 columns (the same maps B4 uses for
        dK = dS^T Q and dV = P^T dO)."""
        rng = np.random.RandomState(1)
        q, k = rng.randn(16, 16), rng.randn(8, 16)
        s = np.zeros((32, 4))
        for ks in range(2):
            s = mma(s, load_a(q[:, 8 * ks:8 * ks + 8], 0.25),
                    load_b_nk(k[:, 8 * ks:8 * ks + 8]))
        np.testing.assert_allclose(_c_matrix(s), 0.25 * q @ k.T, rtol=1e-13)
        dq = np.concatenate([
            _c_matrix(mma(np.zeros((32, 4)), acc_as_a(s),
                          load_b_kn(k[:, 8 * d:8 * d + 8])))
            for d in range(2)
        ], axis=1)
        np.testing.assert_allclose(dq, 0.25 * q @ k.T @ k, rtol=1e-12)


# (name, q position of the warp's first row, k position of the first key,
# causal, window): no mask; a causal diagonal inside the second chunk; rows
# 0..7 seeing no key (dead) and rows 8..15 part of the first chunk; a
# window cutting the first chunk.
WARP_CASES = [
    ("full", 0, 0, False, None),
    ("causal_diagonal", 40, 0, True, None),
    ("k_offset_dead_rows", 0, 8, True, None),
    ("window", 60, 0, True, 40),
]


class TestForwardChunk:
    @pytest.mark.parametrize(
        "q_pos0,k_pos0,causal,window", [c[1:] for c in WARP_CASES],
        ids=[c[0] for c in WARP_CASES],
    )
    def test_warp_equals_the_plain_recurrence(self, q_pos0, k_pos0, causal, window):
        q, k, v = _operands(1)
        scale = q.shape[1] ** -0.5
        args = (q, k, v, scale, q_pos0, k_pos0, causal, window)
        o, l, m = warp_forward(*args)
        ref_o, ref_l, ref_m = plain_forward(*args)
        np.testing.assert_allclose(o, ref_o, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(l, ref_l, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(m == NEG_INF, ref_m == NEG_INF)
        np.testing.assert_allclose(m, ref_m, rtol=1e-12)
        # The same as one step over all 64 keys (the plain version's tile).
        whole_o, whole_l, _ = plain_forward(*args, step=64)
        np.testing.assert_allclose(o, whole_o, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(l, whole_l, rtol=1e-12, atol=1e-12)
        dead = ref_m == NEG_INF
        if k_pos0 > q_pos0:
            assert dead[:k_pos0 - q_pos0].all() and not dead[k_pos0 - q_pos0:].any()
        assert np.all(o[dead] == 0.0) and np.all(l[dead] == 0.0)

    @pytest.mark.parametrize(
        "q_pos0,k_pos0,causal,window", [c[1:] for c in WARP_CASES],
        ids=[c[0] for c in WARP_CASES],
    )
    def test_warp_equals_the_plain_recurrence_at_d16(self, q_pos0, k_pos0,
                                                      causal, window):
        """D = 16, the smallest built size: two k-steps of S = Q K^T and
        two 8-wide n-tiles of O per chunk."""
        q, k, v = _operands(3, dim=16)
        args = (q, k, v, 16 ** -0.5, q_pos0, k_pos0, causal, window)
        o, l, m = warp_forward(*args)
        ref_o, ref_l, ref_m = plain_forward(*args)
        assert o.shape == (16, 16)
        np.testing.assert_allclose(o, ref_o, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(l, ref_l, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(m == NEG_INF, ref_m == NEG_INF)

    def test_a_lane_local_maximum_gives_a_wrong_output(self):
        """Without the quad reduction each lane scales its own columns by
        its own maximum, and P V sums over all four lanes' columns: the
        normalized output is wrong."""
        q, k, v = _operands(2)
        scale = q.shape[1] ** -0.5
        args = (q, k, v, scale, 0, 0, False, None)
        o, l, _ = warp_forward(*args, reduce_max=lambda x: x)
        ref_o, ref_l, _ = plain_forward(*args)
        err = np.abs(o / l[:, None] - ref_o / ref_l[:, None]).max()
        assert err > 1e-2
        good_o, good_l, _ = warp_forward(*args)
        assert np.abs(good_o / good_l[:, None] - ref_o / ref_l[:, None]).max() < 1e-12
