"""Port parity: tensor2robot_tpu_torch.ops.flash_attention vs the JAX package.

The port's plain flash recurrence (what `flash_attention` runs for CPU
tensors, and what the CUDA kernel is held against on the card) is compared
with the JAX Pallas kernel run in interpret mode, over the cases of
tests/test_flash_attention.py: offsets, windows, rectangular tiles, bf16
and fully masked rows. Inputs come from a numpy seed and cross as numpy.
"""

import shutil

import jax
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

    def test_every_header_is_in_the_library_path(self, monkeypatch, tmp_path):
        """A change to any header under csrc/, or a new one, gives another
        library path, so a cached build is never taken for a changed
        source."""
        csrc = tmp_path / "csrc"
        shutil.copytree(flash._CSRC, csrc)
        monkeypatch.setattr(flash, "_CSRC", csrc)
        monkeypatch.setattr(flash, "_BUILD_DIR", tmp_path / "build")
        paths = [flash.library_path(32, "flash_bwd")]
        assert paths[0] == flash.library_path(32, "flash_bwd")
        assert paths[0].parent == tmp_path / "build"
        (csrc / "flash_mma.cuh").write_text(
            (csrc / "flash_mma.cuh").read_text() + "\n// changed\n"
        )
        paths.append(flash.library_path(32, "flash_bwd"))
        (csrc / "flash_extra.cuh").write_text("#pragma once\n")
        paths.append(flash.library_path(32, "flash_bwd"))
        paths.append(flash.library_path(64, "flash_bwd"))
        assert len(set(paths)) == 4
        assert all(p.name.startswith("flash_bwd_d") for p in paths)

    def test_auto_dispatch_threshold_is_the_jax_constant(self):
        assert flash.FLASH_AUTO_SEQ == jax_flash.FLASH_AUTO_SEQ


# -- the training kernels: B1 forward, B3/B4 backward, and their Function ----


def _jax_tile(arrays, **kw):
    q, k, v = (jnp.asarray(a) for a in arrays)
    o, l, m = jax_flash.flash_attention_tile(
        q, k, v, interpret=True, block_q=16, block_k=16, **kw
    )
    return np.asarray(o), np.asarray(l), np.asarray(m)


# Forward/backward tile cases: the CASES above plus fully masked rows.
TILE_CASES = [c for c in CASES if c[0] in (
    "causal", "rect_noncausal", "window_7", "window_offset",
)] + [("k_offset_masked_rows", (0, 64), dict(causal=True, k_offset=32))]


class TestTilePlainMatchesPallasKernel:
    @pytest.mark.parametrize(
        "rows,kw", [c[1:] for c in TILE_CASES], ids=[c[0] for c in TILE_CASES]
    )
    def test_o_l_m(self, qkv, rows, kw):
        """B1's plain version against `flash_attention_tile` (the Pallas
        `_flash_tile_kernel` in interpret mode): the unnormalized output
        and both row stats."""
        arrays = _slices(qkv, rows)
        expected = _jax_tile(arrays, **kw)
        got = flash.flash_attention_tile_plain(
            *(torch.from_numpy(a) for a in arrays), **kw
        )
        for name, g, e in zip("olm", got, expected):
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(
                g.numpy(), e, rtol=F32_TOL, atol=F32_TOL, err_msg=name
            )

    def test_dispatch_takes_the_plain_version_on_the_cpu(self, qkv):
        tensors = [torch.from_numpy(a) for a in qkv]
        before = flash.flash_tile_kernel.launches
        got = flash.flash_attention_tile(*tensors, causal=True)
        want = flash.flash_attention_tile_plain(*tensors, causal=True)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert flash.flash_tile_kernel.launches == before


class TestBwdPlainMatchesPallasKernels:
    @pytest.mark.parametrize(
        "rows,kw", [c[1:] for c in TILE_CASES], ids=[c[0] for c in TILE_CASES]
    )
    def test_dq_dk_dv(self, qkv, rows, kw):
        """B3/B4's plain versions against `flash_attention_bwd_tile` (the
        Pallas `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` in
        interpret mode) on the same lse and delta."""
        q, k, v = _slices(qkv, rows)
        dout = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
        o, l, m = _jax_tile((q, k, v), **kw)
        l_safe = np.maximum(l, 1e-30)
        out = o / np.transpose(l_safe, (0, 2, 1))[..., None]
        lse = m + np.log(l_safe)
        delta = np.asarray(jax_flash.flash_attention_bwd_delta(
            jnp.asarray(dout), jnp.asarray(out)
        ))
        expected = jax_flash.flash_attention_bwd_tile(
            *(jnp.asarray(a) for a in (q, k, v, dout, lse, delta)),
            interpret=True, block_q=16, block_k=16, **kw,
        )
        torch_delta = flash.flash_attention_bwd_delta(
            torch.from_numpy(dout), torch.from_numpy(out)
        )
        np.testing.assert_allclose(torch_delta.numpy(), delta, rtol=1e-6, atol=1e-6)
        got = flash.flash_attention_bwd_plain(
            *(torch.from_numpy(a) for a in (q, k, v, dout, lse, delta)), **kw
        )
        for name, g, e in zip(("dq", "dk", "dv"), got, expected):
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(
                g.numpy(), np.asarray(e), rtol=F32_TOL, atol=F32_TOL,
                err_msg=name,
            )
        if kw.get("k_offset"):
            assert np.all(got[0][:, :kw["k_offset"]].numpy() == 0.0)


def _port_grads(arrays, loss_fn, dtype=torch.float32, **kw):
    tensors = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = flash.flash_attention(*tensors, **kw)
    assert isinstance(out.grad_fn, flash.FlashAttentionFunction._backward_cls)
    loss_fn(out).backward()
    return [t.grad for t in tensors]


def _jax_grads(arrays, loss_fn, dtype=jnp.float32, **kw):
    def f(q, k, v):
        return loss_fn(jax_flash.flash_attention(
            q, k, v, interpret=True, block_q=16, block_k=16, **kw
        ))

    return jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in arrays)
    )


DOUT = np.random.RandomState(7).randn(2, 64, 4, 16).astype(np.float32)
# The gradient cases of tests/test_flash_attention.py, each at that
# file's own tolerance: (name, q rows, kwargs, loss, tolerance).
GRAD_CASES = [
    ("causal_sum", (0, 64), dict(causal=True), "sum", 2e-5),
    ("rect_offsets_noncausal", (16, 48), dict(causal=False, q_offset=16),
     "square", 2e-4),
    ("rect_offsets_causal", (16, 48), dict(causal=True, q_offset=16),
     "square", 2e-4),
    ("window_7", (0, 64), dict(causal=True, window=7), "dout", 3e-5),
    ("window_32", (0, 64), dict(causal=True, window=32), "dout", 3e-5),
    ("k_offset_masked_rows", (0, 64), dict(causal=True, k_offset=32), "dout",
     2e-5),
]


def _losses(name, lib):
    if name == "sum":
        return lambda o: o.sum()
    if name == "square":
        return lambda o: (o ** 2).sum()
    dout = jnp.asarray(DOUT) if lib is jnp else torch.from_numpy(DOUT)
    return lambda o: (o * dout).sum()


class TestFunctionGradientsMatchJax:
    @pytest.mark.parametrize(
        "rows,kw,loss,tol", [c[1:] for c in GRAD_CASES],
        ids=[c[0] for c in GRAD_CASES],
    )
    def test_f32(self, qkv, rows, kw, loss, tol):
        """FlashAttentionFunction's explicit backward (plain B1, B3, B4 on
        the CPU) against jax.grad through the JAX custom VJP (the Pallas
        kernels in interpret mode)."""
        arrays = _slices(qkv, rows)
        expected = _jax_grads(arrays, _losses(loss, jnp), **kw)
        got = _port_grads(arrays, _losses(loss, torch), **kw)
        for name, g, e in zip(("dq", "dk", "dv"), got, expected):
            np.testing.assert_allclose(
                g.numpy(), np.asarray(e), rtol=tol, atol=tol, err_msg=name
            )
        if kw.get("k_offset"):
            assert np.all(got[0][:, :kw["k_offset"]].numpy() == 0.0)
            assert all(torch.isfinite(g).all() for g in got)

    def test_bf16_grads_keep_the_input_dtype(self, qkv):
        expected = _jax_grads(
            qkv, lambda o: o.astype(jnp.float32).sum(), dtype=jnp.bfloat16,
            causal=True,
        )
        got = _port_grads(
            qkv, lambda o: o.float().sum(), dtype=torch.bfloat16, causal=True
        )
        for name, g, e in zip(("dq", "dk", "dv"), got, expected):
            assert g.dtype == torch.bfloat16, name
            np.testing.assert_allclose(
                g.float().numpy(), np.asarray(e, np.float32), rtol=0.1,
                atol=0.1, err_msg=name,
            )

    def test_matches_autograd_through_the_reference(self, qkv):
        """The explicit backward against plain autograd through the
        einsum path (the port's own oracle, as the JAX test's)."""
        got = _port_grads(qkv, _losses("dout", torch), causal=True, window=7)
        tensors = [torch.from_numpy(a).requires_grad_() for a in qkv]
        out = flash.reference_attention(*tensors, causal=True, window=7)
        (out * torch.from_numpy(DOUT)).sum().backward()
        for g, t in zip(got, tensors):
            np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=3e-5, atol=3e-5)


class TestDispatch:
    def test_grad_inputs_take_the_function_and_no_kernel(self, qkv):
        tensors = [torch.from_numpy(a).requires_grad_() for a in qkv]
        before = {n: k.launches for n, k in flash.KERNELS.items()}
        out = flash.flash_attention(*tensors, causal=True)
        assert isinstance(out.grad_fn, flash.FlashAttentionFunction._backward_cls)
        out.sum().backward()
        assert {n: k.launches for n, k in flash.KERNELS.items()} == before
        with torch.no_grad():
            assert flash.flash_attention(*tensors, causal=True).grad_fn is None

    def test_forward_kernel_refuses_grad_inputs_before_the_device(self, qkv):
        """B2's output has no grad_fn: given inputs that require grad it
        would cut attention out of the gradient, so it raises (checked
        before the device, so a CPU tensor shows it)."""
        tensors = [torch.from_numpy(a).requires_grad_() for a in qkv]
        with pytest.raises(RuntimeError, match="gives no gradient"):
            flash.flash_fwd_kernel(*tensors, causal=True)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            flash.flash_fwd_kernel(*tensors, causal=True)

    @pytest.mark.parametrize("name", ["flash_fwd_tile", "flash_bwd_dq",
                                      "flash_bwd_dkv"])
    def test_training_kernels_refuse_cpu_tensors(self, qkv, name):
        q, k, v = (torch.from_numpy(a) for a in qkv)
        stats = torch.zeros(2, 4, 64)
        args = (q, k, v) if name == "flash_fwd_tile" else (q, k, v, q, stats, stats)
        with pytest.raises(ValueError, match="CUDA"):
            flash.KERNELS[name](*args, causal=True)

    def test_bwd_shape_checks(self, qkv):
        q, k, v = (torch.from_numpy(a) for a in qkv)
        stats = torch.zeros(2, 4, 64)
        with pytest.raises(ValueError, match="dout"):
            flash.flash_attention_bwd_plain(q, k, v, q[:, :8], stats, stats)
        with pytest.raises(ValueError, match=r"lse must be \[B, H, Sq\]"):
            flash.flash_attention_bwd_plain(q, k, v, q, stats[:, :2], stats)

    def test_build_rejects_unknown_source(self):
        with pytest.raises(ValueError, match="unknown kernel source"):
            flash.build_library(32, "flash_sideways")


class TestQBlockBounds:
    def test_exact_over_small_grid_including_ragged_tiles(self):
        """[i_lo, i_hi) holds EXACTLY the q-tiles with a visible pair for
        the k-tile (B4's loop), ragged k-tiles and offsets included."""
        for block_q in (2, 3, 8):
            for s_q in (block_q, 3 * block_q - 1):
                num_qb = -(-s_q // block_q)
                for cols in (1, 3, 4):
                    for q_off in (0, 5, -3):
                        for k0 in (0, 7, -4):
                            for window in (None, 1, 2, 5, 100):
                                i_lo, i_hi = flash.q_block_bounds(
                                    k0, cols, block_q, num_qb, q_off, True,
                                    window,
                                )
                                visible = {
                                    qq // block_q
                                    for qq in range(s_q)
                                    for dk in range(cols)
                                    if q_off + qq >= k0 + dk
                                    and (
                                        window is None
                                        or q_off + qq - k0 - dk < window
                                    )
                                }
                                if visible:
                                    assert set(range(i_lo, i_hi)) == visible
