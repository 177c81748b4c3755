"""The split-f32 (3xTF32) products of the flash kernels, emulated.

All four kernels (ops/csrc/flash_fwd.cu: B2, B1; flash_bwd.cu: B3, B4)
run every product on the TF32 tensor cores as lo_a*hi_b + hi_a*lo_b +
hi_a*hi_b, each operand cut into hi = tf32(x) and lo = tf32(x - hi) with
round-to-nearest, ties away from zero (cvt.rna). The card's kernels run
only on the card; here the same arithmetic is emulated in torch on the
f32 bits, and the forward and the backward built from it are held against
the JAX package's Pallas kernels (interpret mode) at the f32 tolerances
the kernels are held to on the card. One TF32 product per product,
emulated the same way, misses those tolerances: that is why the kernels
split. The emulation is a test helper only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import flash_attention as jax_flash
from tensor2robot_tpu_torch.ops import flash_attention as flash

# The kernels vs their plain versions on the card (chip_smoke.KERNEL_TOL,
# f32): B1, B3 and B4 at 1e-4; B2 at the JAX flash tests' 2e-5.
KERNEL_F32_TOL = 1e-4
B2_F32_TOL = 2e-5
# Keys per online-softmax step of the forward kernels (flash_fwd.cu: a
# chunk of 4 n-tiles of 8 keys).
FWD_CHUNK = 32
SHAPE = (1, 256, 2, 32)  # [B, S, H, D]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as cvt.rna.tf32.f32: add half of the dropped 13 bits' range to
    the magnitude bits, then clear them."""
    bits = x.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)


def _visible(s_q, s_k, q_offset, k_offset, window):
    q_pos = q_offset + torch.arange(s_q)
    k_pos = k_offset + torch.arange(s_k)
    visible = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        visible = visible & (q_pos[:, None] - k_pos[None, :] < window)
    return visible


def emulated_bwd(mm, q, k, v, dout, lse, delta, causal, q_offset=0,
                 k_offset=0, window=None):
    """dq, dk, dv [B, S, H, D] as the kernels form them, every product
    through `mm`: P = exp(S - lse) selected by the mask, dS = P (dP -
    delta), dQ = scale dS K, dV = P^T dO, dK = dS^T (q scale)."""
    scale = q.shape[-1] ** -0.5
    qf = q.transpose(1, 2) * scale
    kf, vf, dof = (t.transpose(1, 2) for t in (k, v, dout))
    s = mm(qf, kf.transpose(-1, -2))
    p = torch.exp(s - lse[..., None])
    if causal:
        visible = _visible(q.shape[1], k.shape[1], q_offset, k_offset, window)
        p = torch.where(visible, p, 0.0)
    ds = p * (mm(dof, vf.transpose(-1, -2)) - delta[..., None])
    dq = mm(ds, kf) * scale
    dk = mm(ds.transpose(-1, -2), qf)
    dv = mm(p.transpose(-1, -2), dof)
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


def emulated_fwd(mm, q, k, v, causal, q_offset=0, k_offset=0, window=None):
    """(o [B, Sq, H, D] unnormalized, l [B, H, Sq], m [B, H, Sq]) as the
    forward kernels form them: S = (q scale) K^T and P V through `mm`, an
    online-softmax step per FWD_CHUNK keys with one maximum per row,
    masked logits at the cap -1e30, and a row that has seen no visible key
    contributing exactly 0. (The kernels skip the chunks no row of a warp
    sees; such a chunk changes nothing here either.)"""
    scale = q.shape[-1] ** -0.5
    qf = q.transpose(1, 2) * scale
    kf, vf = k.transpose(1, 2), v.transpose(1, 2)
    s_q, s_k = q.shape[1], k.shape[1]
    o = torch.zeros(qf.shape)
    l = torch.zeros(qf.shape[:-1])
    m = torch.full(qf.shape[:-1], -1e30)
    for c0 in range(0, s_k, FWD_CHUNK):
        c1 = min(c0 + FWD_CHUNK, s_k)
        s = mm(qf, kf[:, :, c0:c1].transpose(-1, -2))
        if causal:
            visible = _visible(s_q, s_k, q_offset, k_offset, window)[:, c0:c1]
            s = torch.where(visible, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p = torch.where((m_new == -1e30)[..., None], 0.0, p)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + mm(p, vf[:, :, c0:c1])
        m = m_new
    return o.transpose(1, 2), l, m


def normalized(o, l):
    """B2's output from B1's: o / max(l, 1e-30)."""
    return o / l.clamp_min(1e-30).transpose(1, 2)[..., None]


class TestTf32Rounding:
    def test_round_to_nearest_ties_away_from_zero(self):
        ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
        x = torch.tensor([
            1.0, 1.0 + ulp, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + 1.5 * ulp,
            1.0 + ulp / 2 - 2.0 ** -23, 3.0 + 0.75 * 2 * ulp, 0.0,
        ])
        want = torch.tensor([
            1.0, 1.0 + ulp, 1.0 + ulp, -(1.0 + ulp), 1.0 + 2 * ulp,
            1.0, 3.0 + 2 * ulp, 0.0,
        ])
        assert torch.equal(tf32_rna(x), want)

    def test_hi_plus_lo_keeps_f32_accuracy(self):
        x = torch.from_numpy(
            np.random.RandomState(3).randn(4096).astype(np.float32) * 10
        )
        hi = tf32_rna(x)
        lo = tf32_rna(x - hi)
        # hi keeps 11 significant bits; lo the next 11 of the residual.
        assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
        assert torch.all((x - hi).abs() <= x.abs() * 2.0 ** -11)
        assert torch.all((x - hi - lo).abs() <= x.abs() * 2.0 ** -21)


def _inputs(seed, rows):
    rng = np.random.RandomState(seed)
    b, s, h, d = SHAPE
    q = rng.randn(b, rows[1] - rows[0], h, d).astype(np.float32)
    k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    dout = rng.randn(*q.shape).astype(np.float32)
    return q, k, v, dout


def _jax_bwd(q, k, v, dout, **kw):
    """lse and delta from the Pallas forward, then the Pallas backward
    (both in interpret mode)."""
    o, l, m = (np.asarray(t) for t in jax_flash.flash_attention_tile(
        *(jnp.asarray(a) for a in (q, k, v)), interpret=True, block_q=64,
        block_k=64, **kw,
    ))
    l_safe = np.maximum(l, 1e-30)
    out = o / np.transpose(l_safe, (0, 2, 1))[..., None]
    lse = m + np.log(l_safe)
    delta = np.asarray(jax_flash.flash_attention_bwd_delta(
        jnp.asarray(dout), jnp.asarray(out)
    ))
    grads = jax_flash.flash_attention_bwd_tile(
        *(jnp.asarray(a) for a in (q, k, v, dout, lse, delta)),
        interpret=True, block_q=64, block_k=64, **kw,
    )
    return lse, delta, [np.asarray(g) for g in grads]


def _past_tolerance(got, want, tol):
    return int((np.abs(got - want) > tol + tol * np.abs(want)).sum())


# (name, q rows, kwargs): the slice's causal case, a window, a q shard
# with its offset, fully masked rows, and a non-causal rectangle.
CASES = [
    ("causal", (0, 256), dict(causal=True)),
    ("window_48", (0, 256), dict(causal=True, window=48)),
    ("q_offset_shard", (128, 256), dict(causal=True, q_offset=128)),
    ("k_offset_masked_rows", (0, 256), dict(causal=True, k_offset=64)),
    ("noncausal_rect", (64, 192), dict(causal=False, q_offset=64)),
]


def _jax_fwd(q, k, v, **kw):
    """The Pallas forward kernels in interpret mode: B1's (o, l, m) and
    B2's normalized output."""
    arrays = [jnp.asarray(a) for a in (q, k, v)]
    tile = jax_flash.flash_attention_tile(
        *arrays, interpret=True, block_q=64, block_k=64, **kw
    )
    out = jax_flash.flash_attention(
        *arrays, interpret=True, block_q=64, block_k=64, **kw
    )
    return [np.asarray(t) for t in tile], np.asarray(out)


class TestSplitF32Forward:
    @pytest.mark.parametrize(
        "rows,kw", [c[1:] for c in CASES], ids=[c[0] for c in CASES]
    )
    def test_matches_jax_forward_where_one_tf32_product_does_not(self, rows, kw):
        q, k, v, _ = _inputs(13, rows)
        (ref_o, ref_l, ref_m), ref_out = _jax_fwd(q, k, v, **kw)
        tensors = [torch.tensor(a) for a in (q, k, v)]
        split = emulated_fwd(split_f32_mm, *tensors, **kw)
        single = emulated_fwd(tf32_mm, *tensors, **kw)
        # B1: o, l and m at the kernel's 1e-4.
        for name, got, want in zip("olm", split, (ref_o, ref_l, ref_m)):
            np.testing.assert_allclose(
                got.numpy(), want, rtol=KERNEL_F32_TOL, atol=KERNEL_F32_TOL,
                err_msg=name,
            )
        # B2: the normalized output at 2e-5, which one TF32 product misses.
        out = normalized(split[0], split[1]).numpy()
        np.testing.assert_allclose(out, ref_out, rtol=B2_F32_TOL, atol=B2_F32_TOL)
        single_out = normalized(single[0], single[1]).numpy()
        split_err = float(np.abs(out - ref_out).max())
        single_err = float(np.abs(single_out - ref_out).max())
        assert single_err > 10 * split_err
        assert _past_tolerance(single_out, ref_out, B2_F32_TOL) > 0
        if kw.get("k_offset"):
            # Rows that see no key: exactly 0, as from the Pallas kernel.
            masked = slice(None, kw["k_offset"])
            assert np.all(out[:, masked] == 0.0)
            assert np.all(split[0].numpy()[:, masked] == 0.0)
            assert np.all(ref_out[:, masked] == 0.0)

    def test_the_plain_versions_agree_with_the_emulation(self):
        """The plain B1 and B2 (full f32 matmuls, one softmax step per
        64-key tile; the kernels' reference on the card) and the split
        emulation (one step per 32 keys) differ by rounding only."""
        q, k, v, _ = _inputs(7, (0, 256))
        tensors = [torch.tensor(a) for a in (q, k, v)]
        split = emulated_fwd(split_f32_mm, *tensors, causal=True)
        plain = flash.flash_attention_tile_plain(*tensors, causal=True)
        for name, s, p in zip("olm", split, plain):
            np.testing.assert_allclose(
                s.numpy(), p.numpy(), rtol=KERNEL_F32_TOL,
                atol=KERNEL_F32_TOL, err_msg=name,
            )
        np.testing.assert_allclose(
            normalized(*split[:2]).numpy(),
            flash.flash_attention_plain(*tensors, causal=True).numpy(),
            rtol=B2_F32_TOL, atol=B2_F32_TOL,
        )


class TestSplitF32Backward:
    @pytest.mark.parametrize(
        "rows,kw", [c[1:] for c in CASES], ids=[c[0] for c in CASES]
    )
    def test_matches_jax_backward_where_one_tf32_product_does_not(self, rows, kw):
        q, k, v, dout = _inputs(11, rows)
        lse, delta, expected = _jax_bwd(q, k, v, dout, **kw)
        tensors = [torch.tensor(a) for a in (q, k, v, dout, lse, delta)]
        split = emulated_bwd(split_f32_mm, *tensors, **kw)
        single = emulated_bwd(tf32_mm, *tensors, **kw)
        split_err, single_err = 0.0, 0.0
        single_past = 0
        for name, s, t, e in zip(("dq", "dk", "dv"), split, single, expected):
            np.testing.assert_allclose(
                s.numpy(), e, rtol=KERNEL_F32_TOL, atol=KERNEL_F32_TOL,
                err_msg=name,
            )
            split_err = max(split_err, float(np.abs(s.numpy() - e).max()))
            single_err = max(single_err, float(np.abs(t.numpy() - e).max()))
            single_past += _past_tolerance(t.numpy(), e, KERNEL_F32_TOL)
        # One TF32 product keeps ~11 bits: far larger errors, and elements
        # past the tolerance the split meets.
        assert single_err > 10 * split_err
        assert single_past > 0
        if kw.get("k_offset"):
            assert np.all(split[0][:, :kw["k_offset"]].numpy() == 0.0)

    def test_the_plain_versions_agree_with_the_emulation(self):
        """The plain B3/B4 (full f32 matmuls, the kernels' reference on
        the card) and the split emulation differ by rounding only."""
        q, k, v, dout = _inputs(5, (0, 256))
        lse, delta, _ = _jax_bwd(q, k, v, dout, causal=True)
        tensors = [torch.tensor(a) for a in (q, k, v, dout, lse, delta)]
        plain = flash.flash_attention_bwd_plain(*tensors, causal=True)
        split = emulated_bwd(split_f32_mm, *tensors, causal=True)
        for name, p, s in zip(("dq", "dk", "dv"), plain, split):
            np.testing.assert_allclose(
                s.numpy(), p.numpy(), rtol=KERNEL_F32_TOL,
                atol=KERNEL_F32_TOL, err_msg=name,
            )
