"""Port parity: weight-only int8 and int4 quantization of exports.

The JAX package quantizes a flax tree per output channel along each
leaf's last axis; the port quantizes its state dict along axis 0 of a
Linear/Conv2d weight (and the last axis of any other leaf). Carried
through utils/jax_params.py, the JAX package's dequantize(quantize(w))
must equal the port's bit for bit, for the tiny BC model's and the
96x96 critic's initialized weights at two size thresholds.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.export import quantization as jax_quantization
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.research.qtopt import t2r_models as jax_qtopt
from tensor2robot_tpu.specs import make_random_numpy as jax_make_random_numpy
from tensor2robot_tpu_torch.export import Exporter, quantization
from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict

BC = dict(episode_length=16, image_size=(16, 16), d_model=32, num_layers=2,
          num_heads=2, head_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _init_params(jax_model, seed):
    preprocessor = jax_model.preprocessor
    features = jax_make_random_numpy(
        preprocessor.get_in_feature_specification("train"), batch_size=2,
        seed=seed)
    features, _ = preprocessor.preprocess(
        features, None, mode="train", rng=jax.random.PRNGKey(seed))
    variables = jax_model.init_variables(jax.random.PRNGKey(seed), features)
    return jax.tree_util.tree_map(np.asarray, dict(variables["params"]))


@pytest.fixture(scope="module")
def params():
    return {
        "bc": _init_params(jax_models.TransformerBCModel(device_type="cpu", **BC), 0),
        "critic": _init_params(
            jax_qtopt.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
                image_size=(96, 96), num_convs=(2, 2, 1)), 1),
    }


@pytest.mark.parametrize("model", ["bc", "critic"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("min_size", [quantization.DEFAULT_MIN_SIZE, 64])
def test_dequantized_weights_bitwise_equal_jax(params, model, bits, min_size):
    flax = params[model]
    jax_q, jax_count = jax_quantization.quantize_variables(
        flax, min_size=min_size, bits=bits)
    want = flax_params_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax_quantization.dequantize_variables(jax_q)))
    state = flax_params_to_state_dict(flax)
    ours, count = quantization.quantize_variables(state, min_size=min_size, bits=bits)
    assert count == jax_count > 0
    got = quantization.dequantize_variables(ours)
    assert set(got) == set(want)
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
        changed = quantization.is_quantized_node(ours[key])
        assert changed == (state[key].ndim >= 2 and state[key].numel() >= min_size)


def test_small_integer_and_vector_leaves_pass_through():
    state = {
        "big.weight": torch.randn(64, 32),
        "vector": torch.randn(4096),
        "small.weight": torch.randn(8, 8),
        "steps": torch.arange(2048, dtype=torch.int64).reshape(32, 64),
    }
    quantized, count = quantization.quantize_variables(state)
    assert count == 1 and quantization.is_quantized(quantized)
    node = quantized["big.weight"]
    assert node[quantization.Q_KEY].dtype == torch.int8
    assert node[quantization.SCALE_KEY].shape == (64,)
    for key in ("vector", "small.weight", "steps"):
        assert quantized[key] is state[key]
    assert not quantization.is_quantized(state)


@pytest.mark.parametrize("bits", [8, 4])
def test_strided_leaves_quantize_to_contiguous_tensors(bits):
    leaf = torch.randn(48, 64).t()  # a converted flax kernel's strides
    node = quantization.quantize_leaf(leaf, axis=0, bits=bits)
    assert all(t.is_contiguous() for t in node.values())
    back = quantization.dequantize_leaf(node)
    scale = node[quantization.SCALE_KEY][:, None]
    assert torch.all((back - leaf).abs() <= scale / 2 + 1e-6)


def test_int4_packs_two_weights_a_byte_and_odd_sizes():
    leaf = torch.randn(33, 31)
    node = quantization.quantize_leaf(leaf, axis=0, bits=4)
    assert node[quantization.Q4_KEY].numel() == (33 * 31 + 1) // 2
    back = quantization.dequantize_leaf(node)
    scale = node[quantization.SCALE_KEY][:, None]
    assert back.shape == leaf.shape
    assert torch.all((back - leaf).abs() <= scale / 2 + 1e-6)


@pytest.mark.parametrize("bits", [0, 2, 16])
def test_bad_bits_are_rejected(bits):
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        quantization.quantize_variables({"w.weight": torch.randn(64, 64)}, bits=bits)
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        Exporter("latest", quantize_weights=True, quantize_bits=bits)
