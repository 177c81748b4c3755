"""Port parity: tensor2robot_tpu_torch.ops.flash_attention vs the JAX package.

The port's plain flash recurrence (what `flash_attention` runs for CPU
tensors, and what the CUDA kernel is held against on the card) is compared
with the JAX Pallas kernel run in interpret mode, over the cases of
tests/test_flash_attention.py: offsets, windows, rectangular tiles, bf16
and fully masked rows. Inputs come from a numpy seed and cross as numpy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import flash_attention as jax_flash
from tensor2robot_tpu_torch.ops import flash_attention as flash

# The JAX flash tests' own tolerance (tests/test_flash_attention.py); bf16
# outputs carry 8 mantissa bits.
F32_TOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.RandomState(0)
    shape = (2, 64, 4, 16)  # [B, S, H, D]
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(3))


def _port(fn, arrays, dtype=torch.float32, **kw):
    tensors = [torch.from_numpy(a).to(dtype) for a in arrays]
    return fn(*tensors, **kw).float().numpy()


def _jax_flash(arrays, dtype=jnp.float32, **kw):
    q, k, v = (jnp.asarray(a, dtype) for a in arrays)
    out = jax_flash.flash_attention(
        q, k, v, interpret=True, block_q=16, block_k=16, **kw
    )
    return np.asarray(out.astype(jnp.float32))


def _slices(qkv, q_rows):
    q, k, v = qkv
    return (q[:, q_rows[0]:q_rows[1]], k, v)


# (name, q row slice, kwargs): the cases of tests/test_flash_attention.py.
CASES = [
    ("full", (0, 64), dict(causal=False)),
    ("causal", (0, 64), dict(causal=True)),
    ("q_offset_shard", (32, 64), dict(causal=True, q_offset=32)),
    ("rect_noncausal", (16, 48), dict(causal=False, q_offset=16)),
    ("rect_causal", (16, 48), dict(causal=True, q_offset=16)),
    ("window_offset", (32, 64), dict(causal=True, q_offset=32, window=24)),
] + [
    (f"window_{w}", (0, 64), dict(causal=True, window=w))
    for w in (1, 7, 16, 33, 64, 200)
]


class TestPlainFlashMatchesPallasKernel:
    @pytest.mark.parametrize(
        "rows,kw", [c[1:] for c in CASES], ids=[c[0] for c in CASES]
    )
    def test_f32(self, qkv, rows, kw):
        arrays = _slices(qkv, rows)
        expected = _jax_flash(arrays, **kw)
        np.testing.assert_allclose(
            _port(flash.flash_attention, arrays, **kw), expected,
            rtol=F32_TOL, atol=F32_TOL,
        )
        np.testing.assert_allclose(
            _port(flash.flash_attention_plain, arrays, **kw), expected,
            rtol=F32_TOL, atol=F32_TOL,
        )

    @pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=7)])
    def test_bf16(self, qkv, kw):
        expected = _jax_flash(qkv, dtype=jnp.bfloat16, **kw)
        got = _port(flash.flash_attention, qkv, dtype=torch.bfloat16, **kw)
        np.testing.assert_allclose(got, expected, rtol=BF16_TOL, atol=BF16_TOL)

    def test_bf16_output_keeps_dtype(self, qkv):
        tensors = [torch.from_numpy(a).to(torch.bfloat16) for a in qkv]
        assert flash.flash_attention(*tensors, causal=True).dtype == torch.bfloat16

    @pytest.mark.parametrize("k_offset", [16, 32, 100])
    def test_fully_masked_rows_are_zero_like_the_kernel(self, qkv, k_offset):
        """q_offset < k_offset: the first rows see no key. The Pallas kernel
        and the port's flash versions give 0 there (ROADMAP C-ref3)."""
        kw = dict(causal=True, k_offset=k_offset)
        expected = _jax_flash(qkv, **kw)
        got = _port(flash.flash_attention, qkv, **kw)
        np.testing.assert_allclose(got, expected, rtol=F32_TOL, atol=F32_TOL)
        assert np.all(got[:, :min(k_offset, 64)] == 0.0)


class TestReferenceAttention:
    @pytest.mark.parametrize(
        "rows,kw", [c[1:] for c in CASES], ids=[c[0] for c in CASES]
    )
    def test_matches_jax_reference(self, qkv, rows, kw):
        arrays = _slices(qkv, rows)
        q, k, v = (jnp.asarray(a) for a in arrays)
        expected = np.asarray(jax_flash.reference_attention(q, k, v, **kw))
        np.testing.assert_allclose(
            _port(flash.reference_attention, arrays, **kw), expected,
            rtol=F32_TOL, atol=F32_TOL,
        )

    def test_fully_masked_rows_are_uniform_like_the_jax_reference(self, qkv):
        kw = dict(causal=True, k_offset=32)
        q, k, v = (jnp.asarray(a) for a in qkv)
        expected = np.asarray(jax_flash.reference_attention(q, k, v, **kw))
        got = _port(flash.reference_attention, qkv, **kw)
        np.testing.assert_allclose(got, expected, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(
            got[:, 0], qkv[2].mean(axis=1), rtol=1e-5, atol=1e-5
        )

    def test_window_requires_causal(self, qkv):
        tensors = [torch.from_numpy(a) for a in qkv]
        for fn in (flash.flash_attention, flash.reference_attention):
            with pytest.raises(ValueError, match="causal"):
                fn(*tensors, causal=False, window=8)
        with pytest.raises(ValueError, match=">= 1"):
            flash.flash_attention(*tensors, causal=True, window=0)


class TestKBlockBounds:
    def test_exact_over_small_grid_including_ragged_tiles(self):
        """For every (q-tile, rows, window, tile sizes, offsets) on a small
        grid, [j_lo, j_hi) holds EXACTLY the k-tiles with a visible pair —
        the same exactness tests/test_flash_attention.py pins for the JAX
        bounds, here with ragged q-tiles and a ragged last k-tile."""
        for block_q in (2, 3, 8):
            for rows in sorted({1, block_q - 1, block_q} - {0}):
                for block_k in (2, 4):
                    for s_k in (block_k, 3 * block_k - 1):
                        num_kb = -(-s_k // block_k)
                        for q_off in (0, 5, -3):
                            for k_off in (0, 7):
                                for q0 in (q_off, q_off + block_q):
                                    for window in (None, 1, 2, 5, 100):
                                        j_lo, j_hi = flash.k_block_bounds(
                                            q0, rows, block_k, num_kb,
                                            k_off, True, window,
                                        )
                                        visible = {
                                            kk // block_k
                                            for dq in range(rows)
                                            for kk in range(s_k)
                                            if q0 + dq >= k_off + kk
                                            and (
                                                window is None
                                                or q0 + dq - k_off - kk < window
                                            )
                                        }
                                        if visible:
                                            assert set(range(j_lo, j_hi)) == visible

    def test_agrees_with_jax_bounds_on_full_tiles(self):
        for q0 in (-5, 0, 16, 37):
            for window in (None, 1, 9, 64):
                for k_off in (0, 16, 40):
                    jax_lo, jax_hi = jax_flash._k_block_bounds(
                        q0, 16, 16, 4, k_off, True, window
                    )
                    assert flash.k_block_bounds(
                        q0, 16, 16, 4, k_off, True, window
                    ) == (int(jax_lo), int(jax_hi))


class TestKernelWrapper:
    def test_cpu_tensors_take_the_plain_version(self, qkv):
        tensors = [torch.from_numpy(a) for a in qkv]
        before = flash.flash_fwd_kernel.launches
        out = flash.flash_attention(*tensors, causal=True)
        assert torch.equal(out, flash.flash_attention_plain(*tensors, causal=True))
        assert flash.flash_fwd_kernel.launches == before

    def test_kernel_refuses_cpu_tensors(self, qkv):
        tensors = [torch.from_numpy(a) for a in qkv]
        with pytest.raises(ValueError, match="CUDA"):
            flash.flash_fwd_kernel(*tensors, causal=True)

    def test_shape_checks(self, qkv):
        q, k, v = (torch.from_numpy(a) for a in qkv)
        with pytest.raises(ValueError, match=r"\[B, S, H, D\]"):
            flash.flash_attention_plain(q[0], k, v)
        with pytest.raises(ValueError, match="must match"):
            flash.flash_attention_plain(q, k, v[:, :32])
        with pytest.raises(ValueError, match="outside the sequence dim"):
            flash.flash_attention_plain(q, k[:, :, :2], v[:, :, :2])
        with pytest.raises(ValueError, match="empty"):
            flash.flash_attention_plain(q[:, :0], k, v)

    def test_build_rejects_unsupported_head_dim(self):
        with pytest.raises(ValueError, match="head dim"):
            flash.build_library(48)

    def test_build_raises_without_nvcc(self, monkeypatch, tmp_path):
        monkeypatch.setattr(flash.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        monkeypatch.setattr(flash, "_BUILD_DIR", tmp_path / "build")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            flash.build_library(32)

    def test_auto_dispatch_threshold_is_the_jax_constant(self):
        assert flash.FLASH_AUTO_SEQ == jax_flash.FLASH_AUTO_SEQ
