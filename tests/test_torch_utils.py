"""The port's utils/global_step_functions.py, t2r_test_fixture.py and
train_eval_test_utils.py, as the JAX package's tests/test_utils.py holds
its own.

  * Global-step schedules equal the JAX package's at every step 0 ... 2x
    the last boundary (or decay period), to float32 rounding (rtol 1e-6),
    with JAX's validation errors.
  * T2RModelFixture trains and predicts MockT2RModel through the port's
    trainer on the CPU; a golden-values file written by one run passes the
    next and catches a perturbation.
  * The gin-config smoke harness runs the shipped run_train_reg.gin over
    records collected from PoseToyEnv.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.utils import global_step_functions as jax_gsf
from tensor2robot_tpu_torch.utils import global_step_functions, train_eval_test_utils
from tensor2robot_tpu_torch.utils.mocks import MockT2RModel
from tensor2robot_tpu_torch.utils.t2r_test_fixture import T2RModelFixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("boundaries,values", [
    ([0, 10, 20], [1.0, 2.0, 0.0]),
    ([5, 7.5, 100, 1000], [0.3, -1.0, 1e-4, 2.5]),
    ([3], [0.7]),
])
def test_piecewise_linear_equals_jax(boundaries, values):
    port = global_step_functions.piecewise_linear(boundaries, values)
    want = jax_gsf.piecewise_linear(boundaries, values)
    steps = np.arange(0, 2 * int(boundaries[-1]) + 2)
    got = port(torch.as_tensor(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want(jnp.asarray(steps))), rtol=RTOL,
                               atol=0)
    for step in (0, int(boundaries[-1]), 2 * int(boundaries[-1])):
        np.testing.assert_allclose(float(port(step)), float(want(step)), rtol=RTOL)


def test_piecewise_linear_interpolates_and_clamps():
    schedule = global_step_functions.piecewise_linear([0, 10, 20], [1.0, 2.0, 0.0])
    for step, value in ((0, 1.0), (5, 1.5), (10, 2.0), (15, 1.0), (100, 0.0)):
        assert float(schedule(step)) == pytest.approx(value)


@pytest.mark.parametrize("boundaries,values,match", [
    ([0, 1], [1.0], "same size"),
    ([0, 0], [1.0, 2.0], "strictly increasing"),
    ([], [], "more than 0"),
])
def test_piecewise_linear_validation_as_jax(boundaries, values, match):
    for module in (global_step_functions, jax_gsf):
        with pytest.raises(ValueError, match=match):
            module.piecewise_linear(boundaries, values)


@pytest.mark.parametrize("staircase", [True, False])
@pytest.mark.parametrize("initial,steps,rate", [(1.0, 10, 0.5), (1e-4, 1000, 0.9),
                                                (3.0, 7, 1.1)])
def test_exponential_decay_equals_jax(staircase, initial, steps, rate):
    port = global_step_functions.exponential_decay(initial, steps, rate, staircase)
    want = jax_gsf.exponential_decay(initial, steps, rate, staircase)
    grid = np.arange(0, 2 * steps + 1)
    got = port(torch.as_tensor(grid)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want(jnp.asarray(grid))), rtol=RTOL, atol=0)


def test_exponential_decay_staircase_steps():
    schedule = global_step_functions.exponential_decay(1.0, 10, 0.5, staircase=True)
    assert float(schedule(9)) == pytest.approx(1.0)
    assert float(schedule(10)) == pytest.approx(0.5)
    smooth = global_step_functions.exponential_decay(1.0, 10, 0.5, staircase=False)
    assert 0.5 < float(smooth(5)) < 1.0


def test_fixture_random_train_and_predict(tmp_path):
    fixture = T2RModelFixture(device="cpu")
    model_dir = str(tmp_path / "run")
    fixture.random_train(MockT2RModel(device_type="cpu"), model_dir)
    train_eval_test_utils.assert_output_files(model_dir)
    outputs = fixture.random_predict(MockT2RModel(device_type="cpu"), model_dir)
    assert outputs["a_predicted"].shape == (2, 1)
    with pytest.raises(AssertionError, match="No files match"):
        train_eval_test_utils.assert_output_files(model_dir, ["eval/*.nothing"])


def test_fixture_golden_roundtrip_detects_regression(tmp_path):
    from tensor2robot_tpu_torch.data.encoder import encode_example
    from tensor2robot_tpu_torch.data.tfrecord import write_tfrecords
    from tensor2robot_tpu_torch.hooks.golden_values_hook_builder import add_golden_tensor
    from tensor2robot_tpu_torch.specs import TensorSpecStruct

    class GoldenModel(MockT2RModel):
        def model_train_fn(self, features, labels, outputs, mode):
            loss, metrics = super().model_train_fn(features, labels, outputs, mode)
            add_golden_tensor(metrics, outputs["a_predicted"], "logits")
            return loss, metrics

    model = GoldenModel(device_type="cpu")
    spec = TensorSpecStruct()
    for key, s in model.preprocessor.get_in_feature_specification("train").items():
        spec[f"features/{key}"] = s
    for key, s in model.preprocessor.get_in_label_specification("train").items():
        spec[f"labels/{key}"] = s
    rng = np.random.RandomState(0)
    records = []
    for _ in range(8):
        values = TensorSpecStruct()
        values["features/x"] = rng.rand(3).astype(np.float32)
        values["labels/a_target"] = np.asarray([float(rng.rand() > 0.5)], np.float32)
        records.append(encode_example(spec, values))
    record_path = str(tmp_path / "data.tfrecord")
    write_tfrecords(record_path, records)

    golden_path = str(tmp_path / "golden" / "golden_values.npy")
    fixture = T2RModelFixture(device="cpu")
    first = fixture.train_and_check_golden_predictions(
        GoldenModel(device_type="cpu"), str(tmp_path / "run1"), [record_path], golden_path)
    assert len(first) == 2 and "logits" in first[0]
    fixture.train_and_check_golden_predictions(
        GoldenModel(device_type="cpu"), str(tmp_path / "run2"), [record_path], golden_path)
    golden = np.load(golden_path, allow_pickle=True)
    golden[0]["logits"] = golden[0]["logits"] + 1.0
    np.save(golden_path, golden)
    with pytest.raises(AssertionError):
        fixture.train_and_check_golden_predictions(
            GoldenModel(device_type="cpu"), str(tmp_path / "run3"), [record_path],
            golden_path)


def test_gin_smoke_runs_the_shipped_pose_config(tmp_path):
    from tensor2robot_tpu_torch import config as cfg
    from tensor2robot_tpu_torch.research import pose_env, run_env
    from tensor2robot_tpu_torch.utils.writer import TFRecordReplayWriter

    run_env.run_env(
        pose_env.PoseToyEnv(seed=0), pose_env.PoseEnvRandomPolicy(seed=0), num_episodes=8,
        episode_to_transitions_fn=lambda ep: pose_env.episode_to_transitions_pose_toy(
            ep, binary_success_threshold=-2.0),
        replay_writer=TFRecordReplayWriter(), output_dir=str(tmp_path / "collect"))
    shards = glob.glob(str(tmp_path / "collect" / "*.tfrecord"))
    assert shards

    def overwrites():
        cfg.bind_macro("TRAIN_DATA", shards)
        cfg.bind_macro("EVAL_DATA", shards)
        for scope in ("train_input_generator", "eval_input_generator"):
            cfg.bind_parameter(f"{scope}/DefaultRecordInputGenerator.batch_size", 4)
            cfg.bind_parameter(f"{scope}/DefaultRecordInputGenerator.num_parse_workers", 0)
        cfg.bind_parameter("PoseEnvRegressionModel.device_type", "cpu")
        cfg.bind_parameter("train_eval_model.device", "cpu")
        cfg.bind_parameter("train_eval_model.create_exporters_fn", None)

    config_path = os.path.join(ROOT, "tensor2robot_tpu", "research", "pose_env", "configs",
                               "run_train_reg.gin")
    model_dir = str(tmp_path / "run")
    train_eval_test_utils.test_train_eval_gin(model_dir, config_path, max_train_steps=2,
                                              eval_steps=1, gin_overwrites_fn=overwrites)
    assert os.path.exists(os.path.join(model_dir, "checkpoints", "2.pt"))
