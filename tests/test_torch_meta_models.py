"""The port's legacy TrainValPair surface (meta_learning/meta_models.py)
against the JAX package's: create_meta_spec's names, shapes, dtypes and
optionality; select_mode's per-task switch; MetaPreprocessor's round trip
(values exact); and an RL^2-style MetalearningModel over the mock model,
from JAX's weights, whose loss and gradients match JAX's within 1e-5 and
1e-4 * max|g| + 1e-7; flatten_and_add_meta_dim's layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.meta_learning import meta_models as jax_meta_models
from tensor2robot_tpu.meta_learning import meta_tfdata as jax_tfdata
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch.meta_learning import meta_models, meta_tfdata
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.utils import jax_params, mocks

TRAIN = "train"
TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _spec_table(spec):
    def dtype(value):
        return str(value).split(".")[-1] if isinstance(value, torch.dtype) else np.dtype(
            value).name

    return {key: (s.name, tuple(s.shape), dtype(s.dtype), s.is_optional)
            for key, s in spec.items()}


@pytest.mark.parametrize("spec_type", ["features", "labels"])
@pytest.mark.parametrize("counts", [(5, 3), (None, None)])
def test_create_meta_spec_matches_jax(spec_type, counts):
    getter = "get_feature_specification" if spec_type == "features" else (
        "get_label_specification")
    want = jax_meta_models.create_meta_spec(
        getattr(jax_mocks.MockT2RModel(), getter)(TRAIN), spec_type, *counts)
    got = meta_models.create_meta_spec(
        getattr(mocks.MockT2RModel(), getter)(TRAIN), spec_type, *counts)
    assert _spec_table(got) == {k: (v[0], v[1], v[2].replace("bool_", "bool"), v[3])
                                for k, v in _spec_table(want).items()}
    assert got.val_mode.name == f"val_mode/{spec_type}"
    with pytest.raises(ValueError, match="spec_type"):
        meta_models.create_meta_spec(mocks.MockT2RModel().get_feature_specification(TRAIN),
                                     "outputs", 5, 3)


@pytest.mark.parametrize("val_mode", [
    np.array([[True], [False], [True], [False]]), np.array([False, True, True, False]),
    np.array(True)])
def test_select_mode_matches_jax(val_mode):
    rng = np.random.RandomState(0)
    train, val = rng.rand(4, 2, 3).astype(np.float32), rng.rand(4, 2, 3).astype(np.float32)
    want = jax_meta_models.select_mode(jnp.asarray(val_mode), {"a": jnp.asarray(train)},
                                       {"a": jnp.asarray(val)})
    got = meta_models.select_mode(torch.from_numpy(val_mode), {"a": torch.from_numpy(train)},
                                  {"a": torch.from_numpy(val)})
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    with pytest.raises(ValueError, match="identical train/val"):
        meta_models.select_mode(torch.tensor(True), {"a": torch.zeros(2)},
                                {"b": torch.zeros(2)})


def _meta_batch(num_tasks, n_train, n_val):
    rng = np.random.RandomState(0)
    features, labels = JaxStruct(), JaxStruct()
    features["train/x"] = rng.uniform(-1, 1, (num_tasks, n_train, 3)).astype(np.float32)
    features["val/x"] = rng.uniform(-1, 1, (num_tasks, n_val, 3)).astype(np.float32)
    features["val_mode"] = (np.arange(num_tasks) % 2 == 1).reshape(num_tasks, 1)
    labels["train/a_target"] = rng.randint(0, 2, (num_tasks, n_train, 1)).astype(np.float32)
    labels["val/a_target"] = rng.randint(0, 2, (num_tasks, n_val, 1)).astype(np.float32)
    labels["val_mode"] = features["val_mode"].copy()
    return features, labels


def _port(structure):
    return TensorSpecStruct({k: torch.from_numpy(np.asarray(v)) for k, v in structure.items()})


def test_meta_preprocessor_matches_jax():
    jax_pre = jax_meta_models.MetaPreprocessor(jax_mocks.MockT2RModel().preprocessor, 5, 3)
    pre = meta_models.MetaPreprocessor(mocks.MockT2RModel().preprocessor, 5, 3)
    assert pre.num_train_samples_per_task == 5 and pre.num_val_samples_per_task == 3
    features, labels = _meta_batch(4, 5, 3)
    want = jax_pre.preprocess(features, labels, mode=TRAIN, rng=jax.random.PRNGKey(0))
    got = pre.preprocess(_port(features), _port(labels), mode=TRAIN)
    for got_part, want_part in zip(got, want):
        assert set(got_part.keys()) == set(want_part.keys())
        for key, value in want_part.items():
            value = np.asarray(value)
            assert tuple(got_part[key].shape) == value.shape, key
            np.testing.assert_array_equal(got_part[key].numpy(), value, err_msg=key)
    assert tuple(got[0].val_mode.shape) == (4, 1)
    with pytest.raises(ValueError, match="mode"):
        pre._preprocess_fn(_port(features), _port(labels), None, None)


class _JaxRL2Mock(jax_meta_models.MetalearningModel):
    """The JAX tests' RL^2-style composition: the base network on the
    val_mode-selected branch, flattened over the meta dim."""

    def init_variables(self, rng, features, mode=TRAIN):
        flat = jax_tfdata.flatten_batch_examples({"x": features["train/x"]})
        return self._base_model.init_variables(rng, flat, mode)

    def inference_network_fn(self, variables, features, mode, rng=None, labels=None):
        selected = jax_meta_models.select_mode(
            features.val_mode, {"x": features["train/x"]}, {"x": features["val/x"]})
        flat = jax_tfdata.flatten_batch_examples(selected)
        outputs, mutable = self._base_model.inference_network_fn(variables, flat, mode,
                                                                 rng=rng)
        return jax_tfdata.unflatten_batch_examples(outputs, features["train/x"].shape[1]), \
            mutable

    def model_train_fn(self, features, labels, inference_outputs, mode):
        selected = jax_meta_models.select_mode(
            labels.val_mode, {"a_target": labels["train/a_target"]},
            {"a_target": labels["val/a_target"]})
        return self._base_model.model_train_fn(
            None, jax_tfdata.flatten_batch_examples(selected),
            jax_tfdata.flatten_batch_examples(inference_outputs), mode)


class _RL2Mock(meta_models.MetalearningModel):
    """The same composition over the port's mock."""

    def create_network(self):
        return self._base_model.create_network()

    def init_network(self, generator=None, device="cpu"):
        return self._base_model.init_network(generator, device)

    def inference_network_fn(self, network, features, mode, labels=None):
        selected = meta_models.select_mode(
            features.val_mode, {"x": features["train/x"]}, {"x": features["val/x"]})
        outputs, updates = self._base_model.inference_network_fn(
            network, meta_tfdata.flatten_batch_examples(selected), mode)
        return meta_tfdata.unflatten_batch_examples(outputs, features["train/x"].shape[1]), \
            updates

    def model_train_fn(self, features, labels, inference_outputs, mode):
        selected = meta_models.select_mode(
            labels.val_mode, {"a_target": labels["train/a_target"]},
            {"a_target": labels["val/a_target"]})
        return self._base_model.model_train_fn(
            None, meta_tfdata.flatten_batch_examples(selected),
            meta_tfdata.flatten_batch_examples(inference_outputs), mode)


def test_metalearning_model_matches_jax():
    jax_model = _JaxRL2Mock(jax_mocks.MockT2RModel(use_batch_norm=False), 4, 4)
    model = _RL2Mock(mocks.MockT2RModel(use_batch_norm=False), 4, 4)
    assert isinstance(model.preprocessor, meta_models.MetaPreprocessor)
    assert set(model.get_feature_specification(TRAIN).keys()) == set(
        jax_model.get_feature_specification(TRAIN).keys())
    features, labels = _meta_batch(3, 4, 4)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init_variables(
        jax.random.PRNGKey(0), features, TRAIN))

    def loss_fn(params):
        outputs, _ = jax_model.inference_network_fn(dict(variables, params=params),
                                                    features, TRAIN)
        return jax_model.model_train_fn(features, labels, outputs, TRAIN)[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(variables["params"])
    network = model.create_network()
    jax_params.load_flax_variables(network, variables)
    outputs, _ = model.inference_network_fn(network, _port(features), TRAIN)
    assert tuple(outputs["a_predicted"].shape) == (3, 4, 1)
    loss, _ = model.model_train_fn(_port(features), _port(labels), outputs, TRAIN)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=TOL, rtol=TOL)
    loss.backward()
    want = jax_params.flax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads))
    for name, param in network.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_TOL * scale + 1e-7, rtol=0, err_msg=name)


def test_flatten_and_add_meta_dim_matches_jax():
    train = {"x": np.zeros((2, 3), np.float32)}
    val = {"x": np.ones((2, 3), np.float32)}
    want = _JaxRL2Mock(jax_mocks.MockT2RModel(), 2, 2).flatten_and_add_meta_dim(
        train, val, np.zeros((1,), bool))
    got = _RL2Mock(mocks.MockT2RModel(), 2, 2).flatten_and_add_meta_dim(
        train, val, np.zeros((1,), bool))
    assert set(got.keys()) == set(want.keys())
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)
    assert got["train/x"].shape == (1, 2, 3)
