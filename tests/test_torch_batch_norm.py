"""The port's flax-semantics BatchNorm against the JAX package's.

tensor2robot_tpu_torch/layers/batch_norm.py vs tensor2robot_tpu/layers/
batch_norm.py (bit-compatible with flax.linen.BatchNorm): train mode
(batch statistics, the running-stat update ra = m * ra + (1 - m) * batch
with the biased variance), eval mode (running statistics), epsilon, the
optional scale, and the gradient of a train-mode forward. The port takes
NCHW (channels on dim 1) where the JAX layer takes NHWC; inputs come from
a numpy seed and cross as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers.batch_norm import BatchNorm as JaxBatchNorm
from tensor2robot_tpu_torch.layers.batch_norm import BatchNorm

# f32 sums over the batch in another order: 1e-6 abs + rel. A train-mode
# output is (x - batch mean) / batch std, so one f32 ulp of a batch mean
# of ~2 (2.4e-7), over a channel std of ~0.5 and times a scale of ~2,
# moves an output near 0 by ~1e-6: train-mode outputs and gradients are
# held to 1e-6 of their largest magnitude, plus 1e-6 relative.
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _case(shape, seed=0):
    rng = np.random.RandomState(seed)
    # An offset and spread per channel, so mean and var are far from 0, 1.
    x = rng.randn(*shape) * rng.uniform(0.5, 3.0, shape[-1]) + rng.randn(shape[-1])
    c = shape[-1]
    variables = {
        "params": {"scale": rng.uniform(0.5, 2.0, c), "bias": rng.randn(c)},
        "batch_stats": {"mean": rng.randn(c), "var": rng.uniform(0.5, 2.0, c)},
    }
    cast = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)
    return x.astype(np.float32), cast(variables)


def _port_layer(variables, use_scale, **kw):
    c = variables["batch_stats"]["mean"].shape[0]
    layer = BatchNorm(c, use_scale=use_scale, **kw)
    with torch.no_grad():
        if use_scale:
            layer.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        layer.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        layer.mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        layer.var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    return layer


def _nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy()) if x.ndim == 4 else torch.from_numpy(x)


def _nhwc(t):
    a = t.detach().numpy()
    return np.moveaxis(a, 1, -1) if a.ndim == 4 else a


SHAPES = [(4, 6, 5, 8), (16, 32), (3, 7, 7, 64)]
SETTINGS = [
    dict(momentum=0.9997, epsilon=1e-3, use_scale=True),
    dict(momentum=0.9997, epsilon=1e-3, use_scale=False),
    dict(momentum=0.99, epsilon=1e-5, use_scale=True),
]


def _jax_variables(variables, use_scale):
    params = dict(variables["params"])
    if not use_scale:
        params.pop("scale")
    return {"params": params, "batch_stats": variables["batch_stats"]}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("kw", SETTINGS, ids=["qtopt", "no_scale", "flax_defaults"])
class TestAgainstJax:
    def test_train_mode_and_running_update(self, shape, kw):
        x, variables = _case(shape)
        module = JaxBatchNorm(use_running_average=False, momentum=kw["momentum"],
                              epsilon=kw["epsilon"], use_scale=kw["use_scale"])
        want, mutated = module.apply(_jax_variables(variables, kw["use_scale"]),
                                     jnp.asarray(x), mutable=["batch_stats"])
        layer = _port_layer(variables, **kw)
        got = layer(_nchw(x), is_training=True)
        want = np.asarray(want)
        np.testing.assert_allclose(_nhwc(got), want, rtol=TOL,
                                   atol=TOL * np.abs(want).max())
        for name in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(layer, name).numpy(),
                np.asarray(mutated["batch_stats"][name]), rtol=TOL, atol=TOL,
            )

    def test_eval_mode_uses_the_running_stats(self, shape, kw):
        x, variables = _case(shape, seed=1)
        module = JaxBatchNorm(use_running_average=True, momentum=kw["momentum"],
                              epsilon=kw["epsilon"], use_scale=kw["use_scale"])
        want = module.apply(_jax_variables(variables, kw["use_scale"]), jnp.asarray(x))
        layer = _port_layer(variables, **kw)
        got = layer(_nchw(x), is_training=False)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=TOL, atol=TOL)
        # Eval leaves the running statistics as they were.
        np.testing.assert_array_equal(layer.mean.numpy(),
                                      variables["batch_stats"]["mean"])

    def test_train_mode_gradients(self, shape, kw):
        x, variables = _case(shape, seed=2)
        rng = np.random.RandomState(3)
        cotangent = rng.randn(*shape).astype(np.float32)
        module = JaxBatchNorm(use_running_average=False, momentum=kw["momentum"],
                              epsilon=kw["epsilon"], use_scale=kw["use_scale"])
        jv = _jax_variables(variables, kw["use_scale"])

        def loss(params, inputs):
            y, _ = module.apply({"params": params, "batch_stats": jv["batch_stats"]},
                                inputs, mutable=["batch_stats"])
            return jnp.sum(y * cotangent)

        want_params, want_x = jax.grad(loss, argnums=(0, 1))(jv["params"], jnp.asarray(x))
        layer = _port_layer(variables, **kw)
        xt = _nchw(x).requires_grad_()
        y = layer(xt, is_training=True)
        (y * _nchw(cotangent)).sum().backward()
        scale = np.abs(np.asarray(want_x)).max()
        np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(want_x),
                                   rtol=TOL, atol=TOL * scale)
        np.testing.assert_allclose(layer.bias.grad.numpy(), want_params["bias"],
                                   rtol=TOL, atol=TOL * np.abs(want_params["bias"]).max())
        if kw["use_scale"]:
            np.testing.assert_allclose(
                layer.weight.grad.numpy(), want_params["scale"], rtol=TOL,
                atol=TOL * np.abs(want_params["scale"]).max())


def test_differs_from_torch_batch_norm_where_it_should():
    """torch's momentum is the complement and its running variance is
    unbiased: the port's update is not nn.BatchNorm2d's."""
    x, variables = _case((4, 3, 3, 2), seed=4)
    layer = _port_layer(variables, use_scale=True, momentum=0.9, epsilon=1e-3)
    layer(_nchw(x), is_training=True)
    batch = _nchw(x).double()
    mean = batch.mean(dim=(0, 2, 3))
    biased = batch.var(dim=(0, 2, 3), unbiased=False)
    expect_var = 0.9 * variables["batch_stats"]["var"] + 0.1 * biased.numpy()
    np.testing.assert_allclose(layer.var.numpy(), expect_var, rtol=1e-5)
    np.testing.assert_allclose(
        layer.mean.numpy(),
        0.9 * variables["batch_stats"]["mean"] + 0.1 * mean.numpy(), rtol=1e-5, atol=1e-6)
    assert layer.state_dict().keys() == {"weight", "bias", "mean", "var"}
    assert set(BatchNorm(2, use_scale=False).state_dict()) == {"bias", "mean", "var"}
