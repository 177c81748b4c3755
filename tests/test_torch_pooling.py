"""The port's TF-padded max pool against the JAX package's.

tensor2robot_tpu_torch/ops/pooling.py (NCHW) vs tensor2robot_tpu/ops/
pooling.py (NHWC) at the Grasping44 tower's odd sizes: 236 -> 79 and
79 -> 27 with 3x3 windows, 27 -> 14 (SAME) or 13 (VALID) with 2x2. Inputs
are relu'd and quantized so windows hold tied maxima. The forward is a
max, and the equal-split backward does the JAX custom VJP's operations
(g / count * mask) in the same dtype, so both are held exactly; so is
T2R_POOL_BACKWARD=native against the JAX native pool's gradient (the first
maximal element of a window takes it all).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.ops import pooling as jax_pooling
from tensor2robot_tpu_torch.ops import pooling


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _tied(shape, seed):
    """relu(x) rounded to quarters: many exact zeros and repeated values."""
    rng = np.random.RandomState(seed)
    return np.maximum(np.round(rng.randn(*shape) * 4) / 4, 0).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


# (input size, window, padding, output size)
CASES = [
    (236, 3, "SAME", 79),
    (79, 3, "SAME", 27),
    (27, 2, "SAME", 14),
    (236, 3, "VALID", 78),
    (79, 3, "VALID", 26),
    (27, 2, "VALID", 13),
]


@pytest.mark.parametrize("size,window,padding,out", CASES,
                         ids=[f"{c[0]}_w{c[1]}_{c[2]}" for c in CASES])
class TestAgainstJax:
    def _run(self, size, window, padding, jax_fn, monkeypatch, mode):
        monkeypatch.setenv("T2R_POOL_BACKWARD", mode)
        x = _tied((2, size, size, 3), seed=size)
        g = np.random.RandomState(1).randn(
            2, *(2 * [-(-size // window) if padding == "SAME" else size // window]), 3
        ).astype(np.float32)
        want, vjp = jax.vjp(lambda a: jax_fn(a, (window, window), padding), jnp.asarray(x))
        (want_grad,) = vjp(jnp.asarray(g))
        xt = _nchw(x).requires_grad_()
        got = pooling.max_pool(xt, (window, window), padding)
        got.backward(_nchw(g))
        return got, np.asarray(want), xt.grad, np.asarray(want_grad)

    def test_forward_and_equal_split_backward(self, size, window, padding, out,
                                              monkeypatch):
        got, want, grad, want_grad = self._run(
            size, window, padding, jax_pooling.max_pool_nonoverlap, monkeypatch,
            "auto")
        assert got.shape[2:] == (out, out)
        np.testing.assert_array_equal(_nhwc(got), want)
        np.testing.assert_array_equal(_nhwc(grad), want_grad)
        # Ties were there to split: some input took a fraction of a window.
        frac = np.abs(want_grad[want_grad != 0])
        assert (frac < np.abs(want_grad).max()).any()

    def test_native_backward(self, size, window, padding, out, monkeypatch):
        got, want, grad, want_grad = self._run(
            size, window, padding, jax_pooling._native_pool, monkeypatch,
            "native")
        np.testing.assert_array_equal(_nhwc(got), want)
        np.testing.assert_array_equal(_nhwc(grad), want_grad)


@pytest.mark.parametrize("size,window,pads", [(236, 3, (0, 1)), (79, 3, (1, 1)),
                                              (27, 2, (0, 1)), (78, 3, (0, 0))])
def test_same_pads_differ_from_torch_symmetric_padding(size, window, pads):
    assert pooling.same_pads(size, window) == pads


def test_auto_and_scatterfree_take_the_equal_split(monkeypatch):
    for mode, path in (("auto", "scatterfree"), ("scatterfree", "scatterfree"),
                       ("native", "native")):
        monkeypatch.setenv("T2R_POOL_BACKWARD", mode)
        assert pooling.resolve_backward_mode() == path
    monkeypatch.setenv("T2R_POOL_BACKWARD", "selectandscatter")
    with pytest.raises(ValueError, match="T2R_POOL_BACKWARD"):
        pooling.resolve_backward_mode()
