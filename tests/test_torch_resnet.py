"""The port's ResNet (layers/resnet.py) against the JAX package's.

  * ResNet v1 and v2, with and without FiLM, at sizes 18 and 50, on 32x32
    and 37x37 images, from the same seeded variables (JAX's layout,
    carried over with utils/jax_params.load_flax_variables): the logits
    and every endpoint in eval mode in float32, and in train mode the
    logits, every endpoint and the updated batch-norm statistics in
    float64 (jax.enable_x64 on the JAX side), all within 1e-5 relative and
    1e-5 of max(1, the tensor's max) absolute (a conv sums up to 4608
    products, so float32 rounds at the scale of the tensor; values reach
    ~9 here).
    Train mode is held in float64 because at these sizes the last block
    layer is 1x1 or 2x2, so its batch norms normalize by the variance of
    a few samples, E[x^2] - E[x]^2 in float32 cancels, and the two
    packages' reduction orders then differ by up to 0.96 of a ResNet-50
    endpoint's max at 32x32 (5.5e-5 of ResNet-18's at 37x37); in float64
    the two agree within 4e-11.
  * The gradient of a loss of the logits and the block_layer4 endpoint
    with respect to every parameter, within 1e-4 of each leaf's max: in
    train mode in float64 at 33x33, and in eval mode (the running
    statistics) in float32 at 37x37. In train mode float32 cannot be held
    to that at any size a test affords: at 64x64 and a batch of 4 the
    losses already differ by 3e-4 relative, for the cancellation above.
  * The stem's max pool pads as flax's "SAME" pool ((0, 1) on an even
    input): the test fails for torch's padding=1.
  * get_block_sizes and the FiLM generator's enabled layers.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensor2robot_tpu.layers import resnet as jax_resnet
from tensor2robot_tpu_torch.layers import resnet
from tensor2robot_tpu_torch.utils import jax_params

TOL = 1e-5
GRAD_TOL = 1e-4
EMBED = 6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded_variables(shapes, seed=1):
    """Seeded numpy values in the layout of a flax variables tree: kernels
    normal / sqrt(fan in), batch-norm variances uniform in [0.5, 1.5],
    scales 1 + 0.1 normal, every other leaf 0.05 normal."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def assert_close(got, want, tol, name=""):
    """Within tol relative and tol * max(1, max|want|) absolute: a deep
    tower's float32 sums round at the scale of the tensor, not of each
    element."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=name)


def assert_grads_close(got, want, tol=GRAD_TOL):
    """Each parameter's gradient within tol * max|want| + 1e-7 of JAX's
    (a parameter the loss does not reach has no torch gradient and a zero
    JAX one)."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for key, ref in want.items():
        ref = ref.numpy()
        value = np.zeros_like(ref) if got[key] is None else got[key].numpy()
        bound = tol * np.abs(ref).max() + 1e-7
        err = np.abs(value - ref).max()
        assert err <= bound, f"{key}: {err} > {bound}"


def grads_as_state_dict(grads):
    return jax_params.flax_params_to_state_dict(host(grads))


CASES = [(size, version, film, hw) for size in (18, 50) for version in (1, 2)
         for film in (False, True) for hw in (32, 37)]


def _ids(case):
    size, version, film, hw = case
    return f"r{size}-v{version}-{'film' if film else 'plain'}-{hw}"


def _models(size, version, film):
    enabled = (True, False, True, True) if film else None
    jax_model = jax_resnet.ResNet(num_classes=5, resnet_size=size, version=version,
                                  film_enabled_block_layers=enabled)
    port = resnet.ResNet(num_classes=5, resnet_size=size, version=version,
                         film_enabled_block_layers=enabled,
                         film_embedding_size=EMBED if film else None)
    return jax_model, port


def _inputs(hw, film, seed=0, batch=2):
    rng = np.random.RandomState(seed)
    images = rng.uniform(0, 1, (batch, hw, hw, 3)).astype(np.float32)
    embedding = rng.standard_normal((batch, EMBED)).astype(np.float32) if film else None
    return images, embedding


def float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _torch(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_matches_jax(case):
    size, version, film, hw = case
    jax_model, port = _models(size, version, film)
    images, embedding = _inputs(hw, film)
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), images, False, film_embedding=embedding))
    variables = seeded_variables(shapes)
    jax_params.load_flax_variables(port, variables)

    logits, endpoints = jax_model.apply(variables, images, False, film_embedding=embedding,
                                        return_intermediate_values=True)
    with torch.no_grad():
        got, got_endpoints = port(_torch(images), False, _torch(embedding),
                                  return_intermediate_values=True)
    assert set(got_endpoints) == set(endpoints)
    assert_close(got, logits, TOL, "logits")
    for key, want in endpoints.items():
        assert got_endpoints[key].shape == want.shape, key
        assert_close(got_endpoints[key], want, TOL, key)

    images, embedding = _inputs(hw, film, seed=1, batch=4)
    with jax.enable_x64(True):
        variables = float64(variables)
        (logits, endpoints), updates = jax_model.apply(
            variables, images.astype(np.float64), True,
            film_embedding=None if embedding is None else embedding.astype(np.float64),
            return_intermediate_values=True, mutable=["batch_stats"])
        logits, endpoints, updates = host((logits, endpoints, updates))
    port = port.double()
    with torch.no_grad():
        got, got_endpoints = port(_torch(images).double(), True,
                                  None if embedding is None else _torch(embedding).double(),
                                  return_intermediate_values=True)
    assert got.dtype == torch.float64 and logits.dtype == np.float64
    assert_close(got, logits, TOL, "train logits")
    for key, want in endpoints.items():
        assert_close(got_endpoints[key], want, TOL, f"train {key}")
    state = port.state_dict()
    for key, want in jax_params.flax_variables_to_state_dict(
            {"batch_stats": updates["batch_stats"]}).items():
        assert_close(state[key], want, TOL, key)


GRAD_CASES = [(18, "float64", 33, True), (50, "float64", 33, True),
              (18, "float32", 37, False), (50, "float32", 37, False)]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=lambda c: f"r{c[0]}-{c[1]}-{'train' if c[3] else 'eval'}")
def test_gradients_match_jax(case):
    """d/dparams of sum(logits^2) + mean(block_layer4) (v2, FiLM on)."""
    size, dtype, hw, train = case
    jax_model, port = _models(size, 2, True)
    images, embedding = _inputs(hw, True, seed=3)
    shapes = jax.eval_shape(lambda: jax_model.init(
        jax.random.PRNGKey(0), images, False, film_embedding=embedding))
    variables = seeded_variables(shapes, seed=4)
    jax_params.load_flax_variables(port, variables)
    images, embedding = images.astype(dtype), embedding.astype(dtype)

    def loss_fn(params):
        (logits, endpoints), _ = jax_model.apply(
            dict(variables, params=params), images, train, film_embedding=embedding,
            return_intermediate_values=True, mutable=["batch_stats"])
        return jnp.sum(logits ** 2) + jnp.mean(endpoints["block_layer4"])

    with jax.enable_x64(dtype == "float64"):
        if dtype == "float64":
            variables = float64(variables)
        loss, grads = host(jax.value_and_grad(loss_fn)(variables["params"]))
    port = port.to(getattr(torch, dtype))
    logits, endpoints = port(_torch(images), train, _torch(embedding),
                             return_intermediate_values=True)
    got = torch.sum(logits ** 2) + endpoints["block_layer4"].mean()
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), rtol=TOL)
    assert_grads_close({k: p.grad for k, p in port.named_parameters()},
                       grads_as_state_dict(grads))


def test_stem_pool_pads_as_flax_same():
    """On an even input flax's SAME pool pads (0, 1): the first window
    starts at row 0. torch's padding=1 starts it at row -1 and gives other
    maxima."""
    x = np.arange(2 * 6 * 6 * 3, dtype=np.float32).reshape(2, 6, 6, 3)
    x = x * np.where(np.arange(6) % 2, -1.0, 1.0)[None, :, None, None]
    want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME")
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = resnet.max_pool_same(nchw, 3, 2).permute(0, 2, 3, 1)
    assert_close(got, want, 0.0)
    torch_padded = F.max_pool2d(nchw, 3, 2, padding=1).permute(0, 2, 3, 1)
    assert torch_padded.shape == got.shape
    assert not np.allclose(torch_padded.numpy(), np.asarray(want))
    # Odd inputs pad (1, 1) in both.
    odd = torch.from_numpy(x[:, :5, :5]).permute(0, 3, 1, 2)
    want = nn.max_pool(jnp.asarray(x[:, :5, :5]), (3, 3), strides=(2, 2), padding="SAME")
    assert_close(resnet.max_pool_same(odd, 3, 2).permute(0, 2, 3, 1), want, 0.0)


def test_block_sizes_and_film_generator():
    for size in (18, 34, 50, 101, 152, 200):
        assert resnet.get_block_sizes(size) == jax_resnet.get_block_sizes(size)
    with pytest.raises(ValueError, match="resnet_size"):
        resnet.get_block_sizes(19)
    generator = resnet.LinearFilmGenerator(EMBED, [2, 2], [8, 16], [False, True])
    assert not hasattr(generator, "film0") and hasattr(generator, "film1")
    out = generator(torch.zeros(3, EMBED))
    assert out[0] == [None, None] and [t.shape for t in out[1]] == [(3, 32), (3, 32)]
    with pytest.raises(ValueError, match="enabled_block_layers"):
        resnet.LinearFilmGenerator(EMBED, [2, 2], [8, 16], [True])


def test_resnet50_spatial_is_block_layer4():
    model = resnet.ResNet(num_classes=1, resnet_size=50)
    images = torch.rand(1, 32, 32, 3)
    with torch.no_grad():
        spatial = resnet.get_resnet50_spatial(images, model)
        _, endpoints = model(images, return_intermediate_values=True)
    assert spatial.shape == (1, 1, 1, 2048)
    assert torch.equal(spatial, endpoints["block_layer4"])
