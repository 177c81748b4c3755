"""The port's mocks (utils/mocks.py) against the JAX package's: the mock
network's logits on the JAX mock's variables (utils/jax_params.py), in
train mode (batch statistics, and the running statistics they move) and
eval mode (running statistics), within 1e-5; the same data from the same
seed; and the reference's convergence gate: a few hundred steps on the
separable data must classify it.
"""

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils import jax_params
from tensor2robot_tpu_torch.utils.mocks import MockInputGenerator, MockT2RModel

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("use_batch_norm", [True, False])
def test_logits_match_jax_on_carried_weights(use_batch_norm):
    from tensor2robot_tpu.utils.mocks import (
        MockInputGenerator as JaxMockInput,
        MockT2RModel as JaxMock,
    )

    jax_model = JaxMock(device_type="cpu", use_batch_norm=use_batch_norm)
    generator = JaxMockInput(batch_size=8, seed=2)
    generator.set_specification_from_model(jax_model, "train")
    batch = next(iter(generator.create_dataset("train")))
    port_batch = next(iter(_port_generator(8, 2).create_dataset("train")))
    np.testing.assert_array_equal(port_batch["features/x"], batch["features"]["x"])
    np.testing.assert_array_equal(port_batch["labels/a_target"], batch["labels"]["a_target"])
    variables = jax_model.init_variables(jax.random.PRNGKey(3), batch["features"])
    model = MockT2RModel(use_batch_norm=use_batch_norm)
    network = model.create_network()
    jax_params.load_flax_variables(
        network, jax.tree_util.tree_map(np.asarray, dict(variables)))
    features = TensorSpecStruct({"x": torch.from_numpy(np.asarray(batch["features"]["x"]))})
    for mode in ("train", "eval"):
        want, updates = jax_model.inference_network_fn(variables, batch["features"], mode)
        got = network(features, mode)["a_predicted"]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want["a_predicted"]),
                                   rtol=TOL, atol=TOL, err_msg=mode)
        if mode == "train" and use_batch_norm:
            stats = jax_params.flax_variables_to_state_dict(
                {"batch_stats": jax.tree_util.tree_map(np.asarray, updates["batch_stats"])})
            own = network.state_dict()
            for key, value in stats.items():
                np.testing.assert_allclose(own[key].numpy(), value.numpy(),
                                           rtol=TOL, atol=TOL, err_msg=key)
            # Eval then reads the JAX variables' own running statistics.
            jax_params.load_flax_variables(
                network, jax.tree_util.tree_map(np.asarray, dict(variables)))


def _port_generator(batch_size, seed):
    model = MockT2RModel()
    generator = MockInputGenerator(batch_size=batch_size, seed=seed)
    generator.set_specification_from_model(model, "train")
    return generator


def test_numpy_data_matches_jax():
    from tensor2robot_tpu.utils.mocks import MockInputGenerator as JaxMockInput

    for got, want in zip(MockInputGenerator(seed=5).create_numpy_data(64),
                         JaxMockInput(seed=5).create_numpy_data(64)):
        np.testing.assert_array_equal(got, want)


def test_training_converges(tmp_path):
    final = train_eval.train_eval_model(
        MockT2RModel(device_type="cpu"), MockInputGenerator(batch_size=32),
        MockInputGenerator(batch_size=64, seed=9), model_dir=str(tmp_path),
        max_train_steps=200, save_checkpoints_steps=200, eval_steps=4,
        log_every_steps=100, device="cpu")
    assert final["accuracy"] > 0.9
    assert final["loss"] < 0.3
