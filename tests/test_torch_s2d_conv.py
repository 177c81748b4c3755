"""The port's space-to-depth stem (layers/s2d_conv.py) against the JAX
package's, and against the plain strided stem.

  * The stem alone (6x6 stride 2, SAME, no bias, 3 -> 16 channels) at
    96x96 and at the critic's 472x472: S2D vs plain in each package and
    port vs JAX, float32 within STEM_TOL of the output's largest
    magnitude; under bf16 autocast the port's S2D stem within BF16_TOL of
    the float32 plain stem (the JAX bf16 gate of tests/test_qtopt.py).
  * The Grasping44 tower with T2R_STEM_S2D=1 in both packages at 96x96,
    num_convs (2, 2, 1), from the JAX init through utils/jax_params.py:
    the train-mode forward within 1e-5 abs + 1e-4 rel, and every gradient
    of a loss over the logits within GRAD_TOL of its leaf's largest (the
    JAX side jitted with T2R_POOL_BACKWARD=native, ROADMAP C-ref5).
  * A plain-stem checkpoint loads into an S2D tower and back unchanged,
    and both compute the same predictions.
  * Every guard raises: K % S, SAME padding in whole blocks, spatial dims
    divisible by S, a restored bias.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import s2d_conv as jax_s2d
from tensor2robot_tpu.research.qtopt import networks as jax_networks
from tensor2robot_tpu_torch.layers import s2d_conv
from tensor2robot_tpu_torch.research.qtopt import networks
from tensor2robot_tpu_torch.utils import jax_params

STEM_TOL = 2e-5
BF16_TOL = 0.02
ATOL, RTOL = 1e-5, 1e-4
GRAD_TOL = 1e-4
SIZE = (96, 96)
CONVS = (2, 2, 1)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _stem_inputs(hw, seed=0, features=16):
    rng = np.random.RandomState(seed)
    images = rng.rand(2, *hw, 3).astype(np.float32)
    kernel = (rng.standard_normal((6, 6, 3, features)) / np.sqrt(108)).astype(np.float32)
    return images, kernel


def _jax_stem(images, kernel, s2d):
    from flax import linen as nn

    module = (jax_s2d.SpaceToDepthConv(kernel.shape[-1], (6, 6), strides=(2, 2)) if s2d
              else nn.Conv(kernel.shape[-1], (6, 6), strides=(2, 2), padding="SAME",
                           use_bias=False))
    return np.asarray(module.apply({"params": {"kernel": jnp.asarray(kernel)}},
                                   jnp.asarray(images)))


def _port_stem(images, kernel, s2d, dtype=None):
    features = kernel.shape[-1]
    module = (s2d_conv.SpaceToDepthConv(3, features) if s2d
              else networks._Conv(3, features, (6, 6), stride=(2, 2)))
    module.load_state_dict({"weight": torch.from_numpy(kernel).permute(3, 2, 0, 1)})
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        if dtype is None:
            out = module(x)
        else:
            with torch.autocast("cpu", dtype=dtype):
                out = module(x.to(dtype))
    return out.float().permute(0, 2, 3, 1).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("hw", [SIZE, (472, 472), (64, 80)])
def test_stem_s2d_equals_plain_in_both_packages(hw):
    images, kernel = _stem_inputs(hw)
    plain_jax = _jax_stem(images, kernel, s2d=False)
    s2d_jax = _jax_stem(images, kernel, s2d=True)
    plain = _port_stem(images, kernel, s2d=False)
    s2d = _port_stem(images, kernel, s2d=True)
    assert s2d.shape == plain.shape == plain_jax.shape == (2, hw[0] // 2, hw[1] // 2, 16)
    _close(s2d_jax, plain_jax, STEM_TOL)
    _close(s2d, plain, STEM_TOL)
    _close(s2d, s2d_jax, STEM_TOL)
    _close(plain, plain_jax, STEM_TOL)


def test_stem_s2d_in_bf16_within_the_bf16_gate():
    images, kernel = _stem_inputs(SIZE, seed=3)
    want = _port_stem(images, kernel, s2d=False)
    got = _port_stem(images, kernel, s2d=True, dtype=torch.bfloat16)
    _close(got, want, BF16_TOL)
    _close(_port_stem(images, kernel, s2d=False, dtype=torch.bfloat16), want, BF16_TOL)


def test_fold_orders_channels_as_jax():
    """The folded channel of pixel (2i + p, 2j + q), channel c, is
    (p * 2 + q) * C + c, as the JAX package's NHWC fold orders it."""
    x = torch.arange(2 * 3 * 4 * 6, dtype=torch.float32).reshape(2, 3, 4, 6)
    folded = s2d_conv.space_to_depth(x, (2, 2))
    assert folded.shape == (2, 12, 2, 3)
    for p in range(2):
        for q in range(2):
            for c in range(3):
                torch.testing.assert_close(folded[:, (p * 2 + q) * 3 + c],
                                           x[:, c, p::2, q::2], rtol=0, atol=0)


def _inputs(batch=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, *SIZE, 3).astype(np.float32),
            rng.randn(batch, 10).astype(np.float32))


@pytest.fixture(scope="module")
def jax_s2d_tower():
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("T2R_STEM_S2D", "1")
        patch.setenv("T2R_POOL_BACKWARD", "native")
        net = jax_networks.Grasping44(
            grasp_param_blocks=jax_networks.E2E_GRASP_PARAM_BLOCKS, num_convs=CONVS)
        images, params = _inputs()
        variables = jax.tree_util.tree_map(np.asarray, net.init(
            jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(params),
            is_training=False))

        def loss(p, images, grasp):
            (logits, _), _ = net.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                       images, grasp, is_training=True,
                                       mutable=["batch_stats"])
            return jnp.sum(jnp.tanh(logits) ** 2), logits

        (value, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"], jnp.asarray(images), jnp.asarray(params))
    return variables, float(value), np.asarray(logits), jax.tree_util.tree_map(
        np.asarray, grads)


def test_critic_tower_with_s2d_stem_matches_jax(jax_s2d_tower, monkeypatch):
    variables, want_loss, want_logits, want_grads = jax_s2d_tower
    monkeypatch.setenv("T2R_STEM_S2D", "1")
    tower = networks.Grasping44(grasp_param_blocks=networks.E2E_GRASP_PARAM_BLOCKS,
                                num_convs=CONVS, image_size=SIZE)
    assert isinstance(tower.conv1_1, s2d_conv.SpaceToDepthConv)
    jax_params.load_flax_variables(tower, variables)
    images, params = _inputs()
    logits, _ = tower(torch.from_numpy(images), torch.from_numpy(params), is_training=True)
    loss = torch.sum(torch.tanh(logits) ** 2)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=RTOL)
    want = jax_params.flax_params_to_state_dict(want_grads)
    grads = dict(tower.named_parameters())
    assert set(want) == set(grads)
    for name, value in want.items():
        scale = float(value.abs().max())
        np.testing.assert_allclose(grads[name].grad.numpy(), value.numpy(),
                                   atol=GRAD_TOL * scale + 1e-7, rtol=0, err_msg=name)


def test_checkpoints_load_between_the_stems(monkeypatch):
    images, params = _inputs(batch=2, seed=4)
    towers, outputs = {}, {}
    for mode in ("0", "1"):
        monkeypatch.setenv("T2R_STEM_S2D", mode)
        towers[mode] = networks.Grasping44(num_convs=CONVS, image_size=SIZE).eval()
    towers["0"].init_parameters(torch.Generator().manual_seed(0))
    towers["1"].load_state_dict(towers["0"].state_dict())
    for mode, tower in towers.items():
        with torch.no_grad():
            outputs[mode] = tower(torch.from_numpy(images), torch.from_numpy(params))[0]
    _close(outputs["1"].numpy(), outputs["0"].numpy(), STEM_TOL)
    monkeypatch.setenv("T2R_STEM_S2D", "0")
    back = networks.Grasping44(num_convs=CONVS, image_size=SIZE)
    back.load_state_dict(towers["1"].state_dict())
    for key, value in towers["0"].state_dict().items():
        assert torch.equal(back.state_dict()[key], value), key


def test_stem_s2d_flag_has_the_jax_semantics(monkeypatch):
    for mode, on in (("1", True), ("0", False), ("auto", False)):
        monkeypatch.setenv("T2R_STEM_S2D", mode)
        assert s2d_conv.stem_s2d_enabled() is on is jax_s2d.stem_s2d_enabled()
    monkeypatch.delenv("T2R_STEM_S2D")
    assert s2d_conv.stem_s2d_enabled() is False


@pytest.mark.parametrize("kernel,strides,match", [
    ((5, 5), (2, 2), "not a multiple"),
    ((4, 4), (2, 2), "whole number"),
])
def test_geometry_guards_raise(kernel, strides, match):
    with pytest.raises(ValueError, match=match):
        s2d_conv.SpaceToDepthConv(3, 8, kernel, strides)


def test_odd_spatial_dims_raise():
    stem = s2d_conv.SpaceToDepthConv(3, 8)
    with pytest.raises(ValueError, match="not divisible"):
        stem(torch.zeros(1, 3, 10, 11))


def test_a_restored_bias_raises():
    plain = torch.nn.Conv2d(3, 8, 6, stride=2)
    with pytest.raises(ValueError, match="no bias"):
        s2d_conv.SpaceToDepthConv(3, 8).load_state_dict(plain.state_dict())
