"""The port's PoseEnvRegressionModelMAML against the JAX package's.

  * One outer step at num_inner_loop_steps=1, second and first order, from
    the same seeded weights (JAX's variables through utils/jax_params.py)
    on the same raw uint8 task batch, through the port's Trainer: every
    prediction key (the same key set as JAX) within 1e-5, the outer loss
    within 1e-5 rel, each outer gradient within 1e-4 * max|g| + 1e-7 of its
    leaf, and two Adam steps, each from JAX's parameters and moments before
    it (the second through jax_params.optax_adam_state_to_optimizer_state),
    checked as tests/test_torch_pose_env.py::test_adam_steps_match_jax
    checks them.
  * A base network with batch norm (ImagesToFeaturesNet(normalizer=
    "batch_norm")): the MAML forward matches JAX's, and the network's
    buffers are unchanged after it.
  * The shipped run_train_reg_maml.gin's model (device_type 'tpu') under
    the bf16 wrapper: one step against JAX's bf16 step.
  * pack_features with and without a previous episode, equal to JAX's.
  * run_meta_env on seeded hidden-drift PoseToyEnvs with a
    MAMLRegressionPolicy over a CPU CheckpointPredictor: the statistics
    equal JAX's within 1e-5, and the policy's action is the model's
    inference_output on the same packed features.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu import meta_learning as jax_meta
from tensor2robot_tpu.research import pose_env as jax_pose_env
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu_torch import config as cfg
from tensor2robot_tpu_torch import meta_learning
from tensor2robot_tpu_torch.models.tpu_model_wrapper import BFloat16ModelWrapper
from tensor2robot_tpu_torch.predictors import CheckpointPredictor
from tensor2robot_tpu_torch.research import pose_env
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.train.infeed import to_device
from tensor2robot_tpu_torch.utils import jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_LR = 1e-3  # create_adam_optimizer's default in both packages
ORDERS = {"second_order": True, "first_order": False}
TASKS, SAMPLES = 2, 2
# bf16: the loss within the dtype-policy tests' 0.02, and the gradient
# within test_torch_config_defaults.py's bf16 gates (0.3 relative L2 per
# leaf, 0.1 over all leaves) of JAX's bf16 gradient. JAX's own bf16
# gradient lies 0.070 from its float32 one in its worst leaf
# (state_features.conv2.bias) and 0.0055 over all leaves on this batch and
# these weights, within both gates (the test checks that too).
BF16_TOL = 0.02
BF16_GRAD_TOL_LEAF = 0.3
BF16_GRAD_TOL_TREE = 0.1


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _raw_batch(tasks=TASKS, samples=SAMPLES, size=64, seed=0):
    """A raw task batch of the MAML in-spec (uint8 images), rewards in
    [0, 1] so every sample weighs in the loss."""
    rng = np.random.RandomState(seed)
    features, labels = JaxStruct(), JaxStruct()
    features["condition/features/state"] = rng.randint(
        0, 256, (tasks, samples, size, size, 3)).astype(np.uint8)
    features["condition/labels/target_pose"] = rng.uniform(
        -1, 1, (tasks, samples, 2)).astype(np.float32)
    features["condition/labels/reward"] = rng.rand(tasks, samples, 1).astype(np.float32)
    features["inference/features/state"] = rng.randint(
        0, 256, (tasks, samples, size, size, 3)).astype(np.uint8)
    labels["target_pose"] = rng.uniform(-1, 1, (tasks, samples, 2)).astype(np.float32)
    labels["reward"] = rng.rand(tasks, samples, 1).astype(np.float32)
    return features, labels


def _seeded_variables(jax_model, features, seed=1):
    """Seeded numpy values in the layout of the JAX model's variables:
    kernels normal / sqrt(fan in), other leaves normal * 0.05."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jax_model.init_variables(jax.random.PRNGKey(0), features))

    def fill(path, leaf):
        if getattr(path[-1], "key", "") == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _jax_model(use_second_order=True, device_type="cpu", **kwargs):
    return jax_pose_env.PoseEnvRegressionModelMAML(
        base_model=jax_pose_env.PoseEnvRegressionModel(device_type=device_type),
        num_inner_loop_steps=1, use_second_order=use_second_order, **kwargs)


def _model(use_second_order=True, device_type="cpu", **kwargs):
    return pose_env.PoseEnvRegressionModelMAML(
        base_model=pose_env.PoseEnvRegressionModel(device_type=device_type),
        num_inner_loop_steps=1, use_second_order=use_second_order, **kwargs)


def _port_batch(features, labels):
    batch = {f"features/{k}": v for k, v in features.items()}
    batch.update({f"labels/{k}": v for k, v in labels.items()})
    return to_device(batch, "cpu")


def _jax_loss_and_grads(jax_model, variables, features, labels):
    """A jitted (loss, (outputs, metrics)), grads of the JAX model on a raw
    batch, through its own preprocessor."""
    f, l = jax_model.preprocessor.preprocess(features, labels, mode="train", rng=None)

    def loss_fn(params):
        outputs, _ = jax_model.inference_network_fn(dict(variables, params=params), f,
                                                    "train", labels=l)
        loss, metrics = jax_model.model_train_fn(f, l, outputs, "train")
        return loss, (outputs, metrics)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_steps():
    """Per order: the seeded variables, and for each of two Adam steps the
    loss, outputs, metrics and gradient at the step's start, the params
    after it and the Adam moments before and after it."""
    features, labels = _raw_batch()
    runs = {}
    for name, second in ORDERS.items():
        jax_model = _jax_model(second)
        f, _ = jax_model.preprocessor.preprocess(features, labels, mode="train", rng=None)
        variables = _seeded_variables(jax_model, f)
        step_fn = _jax_loss_and_grads(jax_model, variables, features, labels)
        optimizer = jax_model.create_optimizer()
        params = variables["params"]
        opt_state = optimizer.init(params)
        steps = []
        for _ in range(2):
            (loss, (outputs, metrics)), grads = step_fn(params)
            before = _adam_moments(opt_state)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            new_params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
            steps.append(dict(params=_host(params), loss=float(loss), outputs=_host(outputs),
                              metrics=_host(metrics), grads=_host(grads), before=before,
                              after=_adam_moments(opt_state), new_params=_host(new_params)))
            params = new_params
        runs[name] = dict(variables=_host(variables), steps=steps)
    runs["batch"] = (features, labels)
    return runs


def _adam_moments(opt_state):
    import optax

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return dict(count=int(found[0].count), mu=_host(found[0].mu), nu=_host(found[0].nu))


def _state_dict(params):
    return jax_params.flax_params_to_state_dict(params)


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_outer_step_matches_jax(jax_steps, order):
    """Predictions, loss and every outer gradient at the seeded weights."""
    run = jax_steps[order]
    step = run["steps"][0]
    model = _model(ORDERS[order])
    features, labels = jax_steps["batch"]
    batch = _port_batch(features, labels)
    trainer = train_eval.Trainer(model, device="cpu")
    state = trainer.init_state(params=jax_params.flax_variables_to_state_dict(run["variables"]))
    f, l = trainer.preprocess_train(batch)
    with torch.no_grad():
        outputs, _ = model.inference_network_fn(state.network, f, "train", labels=l)
    assert set(outputs.keys()) == set(step["outputs"].keys())
    for key, want in step["outputs"].items():
        np.testing.assert_allclose(outputs[key].numpy(), want, atol=TOL, rtol=TOL, err_msg=key)
    metrics = trainer.train_step(state, batch)
    assert set(metrics) == {"loss"} | set(step["metrics"])
    np.testing.assert_allclose(float(metrics["loss"]), step["loss"], rtol=TOL, atol=0)
    for key in ("inner_loss_0", "inner_loss_1"):
        np.testing.assert_allclose(float(metrics[key]), step["metrics"][key], rtol=TOL)
    want = _state_dict(step["grads"])
    params = dict(state.network.named_parameters())
    assert set(params) == set(want)
    for name, param in params.items():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(),
                                   atol=GRAD_TOL * scale + 1e-7, rtol=0, err_msg=name)


def test_second_order_changes_the_outer_gradient(jax_steps):
    """The port's second-order gradient differs from its first-order one
    by far more than the gradient gate (so the test above tells them
    apart), as JAX's test_second_order_changes_meta_gradient checks."""
    features, labels = jax_steps["batch"]
    grads = {}
    for name, second in ORDERS.items():
        trainer = train_eval.Trainer(_model(second), device="cpu")
        network = trainer.init_state(params=jax_params.flax_variables_to_state_dict(
            jax_steps[name]["variables"])).network
        trainer.backward(network, *trainer.preprocess_train(_port_batch(features, labels)))
        grads[name] = {k: p.grad for k, p in network.named_parameters()}
    first, second = grads["first_order"], grads["second_order"]
    gap = max(float((first[k] - second[k]).abs().max() / second[k].abs().max())
              for k in second)
    assert gap > 100 * GRAD_TOL


def _adam_ill_posed(grads):
    """Elements whose JAX gradient is too small for the two packages to
    agree on Adam's step (tests/test_torch_pose_env.py's rule)."""
    ratio = ADAM_LR * TOL / GRAD_TOL
    return {key: g.abs() <= ratio * float(g.abs().max()) for key, g in grads.items()}


@pytest.mark.parametrize("step_index", [0, 1])
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_adam_steps_match_jax(jax_steps, order, step_index):
    """Each Adam step from JAX's parameters and moments before it: the
    moments after it within 1e-4 of their leaf's largest, the parameters
    within 1e-4 where the step is well posed and elsewhere within Adam's
    bound of one step in both packages."""
    step = jax_steps[order]["steps"][step_index]
    trainer = train_eval.Trainer(_model(ORDERS[order]), device="cpu")
    before = _state_dict(step["params"])
    state = trainer.init_state(params=before)
    if step["before"]["count"]:
        state.optimizer.load_state_dict(jax_params.optax_adam_state_to_optimizer_state(
            step["before"]["mu"], step["before"]["nu"], step["before"]["count"],
            state.optimizer, state.network))
    params = dict(state.network.named_parameters())
    metrics = trainer.train_step(state, _port_batch(*jax_steps["batch"]))
    np.testing.assert_allclose(float(metrics["loss"]), step["loss"], rtol=TOL, atol=0)
    for name, key in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        want = _state_dict(step["after"][key])
        for leaf, param in params.items():
            scale = float(want[leaf].abs().max())
            np.testing.assert_allclose(
                state.optimizer.state[param][name].numpy(), want[leaf].numpy(),
                atol=GRAD_TOL * scale + 1e-12, rtol=0, err_msg=f"{name} {leaf}")
    ill_posed = _adam_ill_posed(_state_dict(step["grads"]))
    expected = _state_dict(step["new_params"])
    for key, value in params.items():
        value = value.detach()
        mask = ill_posed[key]
        for moved in (value, expected[key]):
            assert float(torch.where(mask, (moved - before[key]).abs(), 0.0).max()) <= (
                1.002 * ADAM_LR), key
        np.testing.assert_allclose(value[~mask].numpy(), expected[key][~mask].numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=key)


# -- batch norm in the base network ----------------------------------------------


def _batch_norm_models():
    import flax.linen as jax_nn

    from tensor2robot_tpu.layers import vision_layers as jax_layers
    from tensor2robot_tpu.research.pose_env import pose_env_models as jax_models
    from tensor2robot_tpu_torch.layers.vision_layers import ImagesToFeaturesNet
    from tensor2robot_tpu_torch.research.pose_env import pose_env_models

    class JaxNet(jax_nn.Module):
        @jax_nn.compact
        def __call__(self, features, mode):
            points, _ = jax_layers.ImagesToFeaturesNet(
                normalizer="batch_norm", name="state_features")(features["state"],
                                                                mode == "train")
            pose, _ = jax_layers.ImageFeaturesToPoseNet(num_outputs=2,
                                                        name="pose_net")(points)
            out = JaxStruct()
            out["inference_output"] = pose
            out["state_features"] = points
            return out

    class JaxBase(jax_models.PoseEnvRegressionModel):
        def create_network(self):
            return JaxNet()

    class Base(pose_env_models.PoseEnvRegressionModel):
        def create_network(self):
            network = pose_env_models._PoseRegressionNet(action_size=2)
            network.state_features = ImagesToFeaturesNet(normalizer="batch_norm")
            return network

    return (jax_pose_env.PoseEnvRegressionModelMAML(
                base_model=JaxBase(device_type="cpu"), inner_learning_rate=0.05),
            pose_env.PoseEnvRegressionModelMAML(
                base_model=Base(device_type="cpu"), inner_learning_rate=0.05))


def test_batch_norm_base_matches_jax_and_keeps_its_buffers():
    jax_model, model = _batch_norm_models()
    raw, labels = _raw_batch(size=32, seed=3)
    features = JaxStruct({k: (v.astype(np.float32) / 255.0 if v.dtype == np.uint8 else v)
                          for k, v in raw.items()})
    variables = _seeded_variables(jax_model, features)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x + np.random.RandomState(4).rand(*x.shape) * 0.1).astype(np.float32),
        variables["batch_stats"])
    want = _host(jax.jit(lambda v: jax_model.inference_network_fn(
        v, features, "train", labels=labels)[0])(variables))
    network = model.create_network()
    jax_params.load_flax_variables(network, _host(variables))
    buffers = {name: value.clone() for name, value in network.named_buffers()}
    assert any(name.endswith(".mean") for name in buffers)
    outputs, updates = model.inference_network_fn(
        network, TensorSpecStruct({k: torch.from_numpy(v) for k, v in features.items()}),
        "train", labels=TensorSpecStruct({k: torch.from_numpy(v) for k, v in labels.items()}))
    assert updates == {} and set(outputs.keys()) == set(want.keys())
    for key, value in want.items():
        np.testing.assert_allclose(outputs[key].detach().numpy(), value, atol=TOL, rtol=TOL,
                                   err_msg=key)
    outputs["inference_output"].sum().backward()
    for name, value in network.named_buffers():
        assert torch.equal(value, buffers[name]), name


# -- the shipped config under the bf16 wrapper -------------------------------------


@pytest.fixture
def clean_registry():
    import tensor2robot_tpu_torch.config.defaults  # noqa: F401
    from tensor2robot_tpu_torch.config import registry

    imports = list(registry._REGISTRY.imports)
    cfg.clear_config()
    yield
    cfg.clear_config()
    registry._REGISTRY.imports[:] = imports


def test_shipped_config_trains_under_the_bf16_wrapper_as_jax(jax_steps, clean_registry):
    from tensor2robot_tpu.train.train_eval import maybe_wrap_for_tpu as jax_wrap

    cfg.parse_config_file(os.path.join(ROOT, "tensor2robot_tpu", "research", "pose_env",
                                       "configs", "run_train_reg_maml.gin"))
    model = cfg.get_configurable("PoseEnvRegressionModelMAML")()
    assert isinstance(model, pose_env.PoseEnvRegressionModelMAML)
    assert model.device_type == "tpu" and model.num_inner_loop_steps == 1
    wrapped = train_eval.maybe_wrap_for_tpu(model)
    assert isinstance(wrapped, BFloat16ModelWrapper)

    features, labels = jax_steps["batch"]
    variables = jax_steps["second_order"]["variables"]
    jax_model = jax_wrap(_jax_model(device_type="tpu"))
    (want_loss, _), want_grads = _jax_loss_and_grads(jax_model, variables, features, labels)(
        variables["params"])
    want = _state_dict(_host(want_grads))

    trainer = train_eval.Trainer(wrapped, device="cpu")
    state = trainer.init_state(params=jax_params.flax_variables_to_state_dict(variables))
    metrics = trainer.train_step(state, _port_batch(features, labels))
    assert abs(float(metrics["loss"]) - float(want_loss)) <= BF16_TOL
    port = {name: param.grad for name, param in state.network.named_parameters()}
    jax_f32 = _state_dict(jax_steps["second_order"]["steps"][0]["grads"])
    for grads in (jax_f32, port):  # JAX's own bf16 gap, then the port's
        diff_sq = norm_sq = 0.0
        for name, grad in grads.items():
            diff, norm = float((grad - want[name]).norm()), float(want[name].norm())
            diff_sq, norm_sq = diff_sq + diff ** 2, norm_sq + norm ** 2
            assert diff <= BF16_GRAD_TOL_LEAF * norm, (name, diff / norm)
        assert diff_sq ** 0.5 <= BF16_GRAD_TOL_TREE * norm_sq ** 0.5
    # The float32 step of the same weights differs: the policy is on.
    assert float(metrics["loss"]) != jax_steps["second_order"]["steps"][0]["loss"]


# -- pack_features and the meta-env loop ------------------------------------------


@pytest.mark.parametrize("with_episode", [False, True])
def test_pack_features_matches_jax(with_episode):
    rng = np.random.RandomState(5)
    state = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    obs = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    episodes = [[(obs, rng.uniform(-1, 1, 2).astype(np.float32), 0.8, obs, True, {})]]
    previous = episodes if with_episode else []
    want = _jax_model().pack_features(state, previous, 0)
    got = _model().pack_features(state, previous, 0)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    reward = got["condition/labels/reward/0"]
    np.testing.assert_allclose(reward, [[0.6]] if with_episode else [[0.0]], rtol=1e-6)


def _unbatched(pack_features):
    """pack_features' columns without their batch dim of 1 (RegressionPolicy
    adds the batch dim itself)."""
    return lambda state, context, timestep: {
        key: value[0] for key, value in pack_features(state, context, timestep).items()}


def test_run_meta_env_matches_jax(jax_steps, tmp_path):
    from tensor2robot_tpu.predictors.checkpoint_predictor import (
        CheckpointPredictor as JaxCheckpointPredictor,
    )

    variables = jax_steps["second_order"]["variables"]
    jax_model = _jax_model(preprocessor_cls=jax_meta.FixedLenMetaExamplePreprocessor)
    jax_predictor = JaxCheckpointPredictor(jax_model)
    jax_predictor._variables, jax_predictor._restored_step = variables, 0
    model = _model(preprocessor_cls=meta_learning.FixedLenMetaExamplePreprocessor)
    predictor = CheckpointPredictor(model, device="cpu")
    predictor.load_state_dict(jax_params.flax_variables_to_state_dict(variables))

    stats = []
    for pkg, meta, prediction, maml in ((jax_pose_env, jax_meta, jax_predictor, jax_model),
                                        (pose_env, meta_learning, predictor, model)):
        policy = meta.MAMLRegressionPolicy(prediction, pack_fn=_unbatched(maml.pack_features))
        stats.append(meta.run_meta_env(
            pkg.PoseToyEnv(hidden_drift=True, seed=11), policy, num_tasks=2,
            num_adaptations_per_task=2, root_dir=str(tmp_path / pkg.__name__),
            write_summaries=True))
    want, got = stats
    assert set(got) == set(want) == {"collect/step_0_reward", "collect/step_1_reward",
                                     "collect/step_1_improvement"}
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, atol=TOL, rtol=TOL, err_msg=key)
    written = (tmp_path / pose_env.__name__ / "live_eval_0" / "metrics.jsonl").read_text()
    assert "collect/step_1_improvement" in written

    # The action is the model's inference_output on the same packed features.
    env = pose_env.PoseToyEnv(hidden_drift=True, seed=12)
    obs = env.reset()
    policy = meta_learning.MAMLRegressionPolicy(
        predictor, pack_fn=_unbatched(model.pack_features))
    policy.adapt([[(obs, np.array([0.1, -0.2], np.float32), 0.9, obs, True, {})]])
    action, debug = policy.sample_action(obs)
    assert debug == {"is_demo": False} and action.shape == (2,)
    packed = model.pack_features(obs, policy.prev_episode_data, 0)
    features, _ = model.preprocessor.preprocess(
        TensorSpecStruct({k: torch.from_numpy(v) for k, v in packed.items()}), None,
        mode="predict")
    with torch.no_grad():
        outputs, _ = model.inference_network_fn(predictor._network, features, "predict")
    np.testing.assert_array_equal(action, outputs["inference_output"][0, 0].numpy())


def test_trainer_regimes_leave_a_maml_model_alone(jax_steps):
    """remat trains a MAML model as without it (the pose nets mark no
    segment); grad_accum_steps 2 splits the task axis: its loss and
    gradient are the means of the two half-batches' (the microbatch
    rule of both packages); the network's buffers never move."""
    features, labels = jax_steps["batch"]
    weights = jax_params.flax_variables_to_state_dict(jax_steps["second_order"]["variables"])
    grads = {}
    for name, kwargs in (("plain", {}), ("remat", dict(remat=True)),
                         ("accum", dict(grad_accum_steps=2))):
        trainer = train_eval.Trainer(_model(), device="cpu", **kwargs)
        network = trainer.init_state(params=weights).network
        f, l = trainer.preprocess_train(_port_batch(features, labels))
        loss, metrics = trainer.backward(network, f, l)
        grads[name] = (float(loss), {k: p.grad.clone() for k, p in network.named_parameters()})
        assert set(metrics) == {"loss/weighted_mse", "inner_loss_0", "inner_loss_1"}
    for key, value in grads["plain"][1].items():
        assert torch.equal(grads["remat"][1][key], value), key
    assert grads["remat"][0] == grads["plain"][0]
    halves = []
    for index in range(2):
        trainer = train_eval.Trainer(_model(), device="cpu")
        network = trainer.init_state(params=weights).network
        f, l = trainer.preprocess_train(_port_batch(
            JaxStruct({k: v[index:index + 1] for k, v in features.items()}),
            JaxStruct({k: v[index:index + 1] for k, v in labels.items()})))
        loss, _ = trainer.backward(network, f, l)
        halves.append((float(loss), {k: p.grad for k, p in network.named_parameters()}))
    np.testing.assert_allclose(grads["accum"][0], (halves[0][0] + halves[1][0]) / 2,
                               rtol=TOL)
    for key, value in grads["accum"][1].items():
        want = (halves[0][1][key] + halves[1][1][key]) / 2
        scale = float(want.abs().max())
        np.testing.assert_allclose(value.numpy(), want.numpy(),
                                   atol=GRAD_TOL * scale + 1e-7, rtol=0, err_msg=key)


def test_exporting_a_maml_model_raises_naming_its_item(tmp_path):
    """Exporting a MAML model raises nothing now (ROADMAP A8(f) is ported):
    the plain and the bf16-wrapped model both give a serving module that
    takes gradients, and the plain one exports a static-batch program that
    serves its own eager forward (tests/test_torch_maml_export.py holds the
    programs against the JAX package)."""
    from tensor2robot_tpu_torch.export import saved_model
    from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator

    weights = _model().init_network(torch.Generator().manual_seed(0), "cpu").state_dict()
    for model in (_model(), train_eval.maybe_wrap_for_tpu(_model(device_type="tpu"))):
        generator = DefaultExportGenerator()
        generator.set_specification_from_model(model)
        assert generator.create_serving_fn(weights, device=torch.device("cpu")).takes_gradients
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(_model())
    serving = generator.create_serving_fn(weights, device=torch.device("cpu"))
    example = generator.create_example_features()
    path = saved_model.save_exported_model(
        str(tmp_path), weights, generator.serving_input_spec(), serving_module=serving,
        example_features=example, program_batches=(2,))
    loaded = saved_model.ExportedModel(path, device="cpu")
    assert loaded.metadata["program"] is True and loaded.program_batches == [2]
    with torch.no_grad():
        want = serving({k: torch.from_numpy(v) for k, v in example.items()})
    got = loaded.predict(example)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value.numpy(), atol=1e-6, rtol=1e-6, err_msg=key)
    DefaultExportGenerator().set_specification_from_model(
        pose_env.PoseEnvRegressionModel(device_type="cpu"))
