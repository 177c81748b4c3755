"""Head-dim coverage and the once-differentiable backward of the port's
flash attention (tensor2robot_tpu_torch/ops/flash_attention.py).

The kernels are built for D in KERNEL_HEAD_DIMS = (16, 32, 64, 128); the
wrappers zero-pad any other D up to 128 to the next of them through
`call_padded` and slice the padded columns off, with the scale of the
true D. Here that path runs with the plain versions in place of the
kernels (the kernels need the card): padded and unpadded calls must agree,
and the padded forward must match the JAX Pallas kernel (interpret mode)
at the true D. A second derivative through FlashAttentionFunction must
raise, on the CPU as on the card, instead of silently dropping the
attention term.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import flash_attention as jax_flash
from tensor2robot_tpu_torch.ops import flash_attention as flash

# Zero columns change no product and no sum; padded and unpadded plain
# versions differ only by the rounding of a longer (zero-extended) dot
# product.
PAD_TOL = 1e-6
# The JAX flash tests' own f32 tolerance (tests/test_flash_attention.py).
F32_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _arrays(dim, seed=0, seq=80):
    rng = np.random.RandomState(seed)
    shape = (2, seq, 2, dim)  # [B, S, H, D], a ragged last tile
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(4))


def _bwd_inputs(q, k, v, dout, kw):
    o, l, m = flash.flash_attention_tile_plain(q, k, v, **kw)
    l_safe = l.clamp_min(1e-30)
    out = o / l_safe.transpose(1, 2)[..., None]
    return (q, k, v, dout, m + torch.log(l_safe),
            flash.flash_attention_bwd_delta(dout, out))


class TestKernelHeadDim:
    @pytest.mark.parametrize("dim,size", [
        (1, 16), (8, 16), (16, 16), (17, 32), (24, 32), (32, 32),
        (48, 64), (64, 64), (96, 128), (128, 128),
    ])
    def test_next_built_size(self, dim, size):
        assert flash.kernel_head_dim(dim) == size
        assert flash.block_k_for(dim) == flash.block_k_for(size)

    @pytest.mark.parametrize("dim", [0, 129, 256])
    def test_outside_the_built_sizes_raises_naming_the_limit(self, dim):
        with pytest.raises(ValueError, match="1..128"):
            flash.kernel_head_dim(dim)

    def test_d16_is_a_built_size(self):
        assert flash.KERNEL_HEAD_DIMS == (16, 32, 64, 128)
        for source in flash.KERNEL_SOURCES:
            assert flash.library_path(16, source).name.startswith(f"{source}_d16-")
        header = (flash._CSRC / "flash_common.cuh").read_text()
        assert "T2R_HEAD_DIM == 16 ||" in header


KW = [dict(causal=True), dict(causal=False), dict(causal=True, window=24)]


class TestCallPadded:
    @pytest.mark.parametrize("dim", [16, 24, 48, 100])
    @pytest.mark.parametrize("kw", KW, ids=["causal", "full", "window"])
    def test_padded_plain_versions_equal_the_unpadded(self, dim, kw):
        q, k, v, dout = (torch.from_numpy(a) for a in _arrays(dim))
        pairs = [
            (flash.flash_attention_plain, (q, k, v)),
            (flash.flash_attention_tile_plain, (q, k, v)),
            (flash.flash_attention_bwd_dq_plain, _bwd_inputs(q, k, v, dout, kw)),
            (flash.flash_attention_bwd_dkv_plain, _bwd_inputs(q, k, v, dout, kw)),
        ]
        for fn, args in pairs:
            got = flash.call_padded(fn, *args, **kw)
            want = fn(*args, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g.shape == w.shape
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=PAD_TOL,
                                           atol=PAD_TOL, err_msg=fn.__name__)

    @pytest.mark.parametrize("dim", [24, 48])
    def test_padded_forward_matches_the_pallas_kernel(self, dim):
        q, k, v, _ = _arrays(dim, seed=1, seq=64)
        got = flash.call_padded(
            flash.flash_attention_plain,
            *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
        ).numpy()
        want = np.asarray(jax_flash.flash_attention(
            *(jnp.asarray(a) for a in (q, k, v)), causal=True,
            interpret=True, block_q=16, block_k=16,
        ))
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)

    @pytest.mark.parametrize("name", list(flash.KERNELS))
    @pytest.mark.parametrize("dim", [16, 24, 48])
    def test_each_wrapper_launches_at_the_built_size(self, monkeypatch, name, dim):
        """The wrapper's own path, with its launch replaced by the plain
        version: the launch sees D padded to the built size and the true
        D's scale, and the caller gets the plain version's result."""
        kernel = flash.KERNELS[name]
        plain = {
            "flash_fwd": flash.flash_attention_plain,
            "flash_fwd_tile": flash.flash_attention_tile_plain,
            "flash_bwd_dq": flash.flash_attention_bwd_dq_plain,
            "flash_bwd_dkv": flash.flash_attention_bwd_dkv_plain,
        }[name]
        seen = []

        def run(*args, scale, **kw):
            seen.append((args[0].shape[-1], scale))
            return plain(*args, scale=scale, **kw)

        monkeypatch.setattr(kernel, "_run", run)
        q, k, v, dout = (torch.from_numpy(a) for a in _arrays(dim, seed=2))
        kw = dict(causal=True)
        args = (q, k, v) if name.startswith("flash_fwd") else _bwd_inputs(
            q, k, v, dout, kw)
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        assert seen == [(flash.kernel_head_dim(dim), dim ** -0.5)]
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=PAD_TOL,
                                       atol=PAD_TOL)

    @pytest.mark.parametrize("name", list(flash.KERNELS))
    def test_wrappers_refuse_a_head_dim_past_128(self, name):
        q, k, v, dout = (torch.from_numpy(a) for a in _arrays(160, seq=8))
        lse = torch.zeros(2, 2, 8)
        args = (q, k, v) if name.startswith("flash_fwd") else (
            q, k, v, dout, lse, lse)
        with pytest.raises(ValueError, match="1..128"):
            flash.KERNELS[name](*args)

    def test_dispatch_refuses_a_head_dim_past_128_on_the_cpu_too(self):
        q, k, v, _ = (torch.from_numpy(a) for a in _arrays(160, seq=8))
        with pytest.raises(ValueError, match="1..128"):
            flash.flash_attention(q, k, v, causal=True)
        with pytest.raises(ValueError, match="1..128"):
            flash.flash_attention(q.requires_grad_(), k, v, causal=True)


class TestOnceDifferentiable:
    def _inputs(self):
        q, k, v, _ = _arrays(16, seed=3, seq=32)
        return [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]

    def test_first_derivative_matches_the_reference(self):
        q, k, v = self._inputs()
        grads = torch.autograd.grad(
            (flash.flash_attention(q, k, v, causal=True) ** 2).sum(), (q, k, v))
        ref = torch.autograd.grad(
            (flash.reference_attention(q, k, v, causal=True) ** 2).sum(),
            (q, k, v))
        for g, r in zip(grads, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-5)

    def test_second_derivative_raises(self):
        q, k, v = self._inputs()
        out = flash.flash_attention(q, k, v, causal=True)
        # A residual keeps the first gradient differentiable, as a
        # transformer block's skip connection does.
        loss = ((out + q) ** 2).sum()
        (g,) = torch.autograd.grad(loss, q, create_graph=True)
        assert g.requires_grad
        with pytest.raises(RuntimeError, match="once-differentiable"):
            torch.autograd.grad(g.sum(), q)
        for inputs in ((k,), (q, k, v)):
            (g,) = torch.autograd.grad(
                ((flash.flash_attention(q, k, v, causal=True) + q) ** 2).sum(),
                q, create_graph=True)
            with pytest.raises(RuntimeError, match="once-differentiable"):
                torch.autograd.grad(g.sum(), inputs)
        # .backward() reaches it too.
        (g,) = torch.autograd.grad((out ** 2).sum(), v, create_graph=True)
        with pytest.raises(RuntimeError, match="once-differentiable"):
            g.sum().backward()

    def test_second_derivative_through_the_reference_is_kept(self):
        """The einsum path differentiates twice; only the flash path
        refuses (it would otherwise lose the attention term)."""
        q, k, v = self._inputs()
        out = flash.reference_attention(q, k, v, causal=True)
        (g,) = torch.autograd.grad(((out + q) ** 2).sum(), q, create_graph=True)
        (gg,) = torch.autograd.grad(g.sum(), q)
        assert torch.isfinite(gg).all()
