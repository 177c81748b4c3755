"""The port's PoseToyEnv workload against the JAX package's.

  * PoseToyEnv replays tests/golden/pose_env_golden_trace.npz bit for bit
    (tools/make_pose_env_golden.py's rollout, re-run with the port's env:
    hidden drift, env seed 123, policy seed 7), and steps bit-equal to the
    JAX env from the same seed.
  * episode_to_transitions_pose_toy: float features bit-equal to the JAX
    package's Examples; the JPEG images compared decoded, within the
    libjpeg q95 round-trip bounds of the data slice (mean 3.3526853,
    max 149).
  * The pose nets (PoseEnvRegressionModel, PoseEnvContinuousMCModel) from
    the JAX package's initial variables through utils/jax_params.py:
    forward, loss and the first gradient within 1e-5; two momentum train
    steps within 1e-4; two Adam steps (the model's default), each from
    JAX's state before it, within 1e-4 where Adam's step is well posed.
  * tf_modules and vision_layers twins.
"""

import io

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.research import pose_env as jax_pose_env
from tensor2robot_tpu_torch.research import pose_env
from tensor2robot_tpu_torch.research.dql_grasping_lib import tf_modules
from tensor2robot_tpu_torch.specs import TensorSpecStruct, make_random_numpy
from tensor2robot_tpu_torch.train import infeed, train_eval
from tensor2robot_tpu_torch.utils.jax_params import (
    flax_variables_to_state_dict,
    load_flax_variables,
)

FWD_TOL = 1e-5
STEP_TOL = 1e-4
ROUNDTRIP = (3.3526853, 149)  # libjpeg's q95 round trip, the data slice's bound


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def rollout(num_episodes=5):
    """tools/make_pose_env_golden.py's rollout over the port's env."""
    env = pose_env.PoseToyEnv(hidden_drift=True, seed=123)
    policy = pose_env.PoseEnvRandomPolicy(seed=7)
    observations, actions, rewards, targets = [], [], [], []
    for _ in range(num_episodes):
        env.reset_task()
        obs = env.reset()
        action, _ = policy.sample_action(obs, explore_prob=1.0)
        _, reward, done, debug = env.step(action)
        assert done
        observations.append(obs)
        actions.append(np.asarray(action, np.float32))
        rewards.append(np.float32(reward))
        targets.append(debug["target_pose"])
    return {
        "observations": np.stack(observations),
        "actions": np.stack(actions),
        "rewards": np.stack(rewards),
        "target_poses": np.stack(targets),
    }


class TestPoseToyEnv:
    def test_golden_trace(self):
        from tools.make_pose_env_golden import GOLDEN_PATH

        golden = np.load(GOLDEN_PATH)
        trace = rollout()
        for key in ("observations", "actions", "rewards", "target_poses"):
            assert trace[key].dtype == golden[key].dtype, key
            np.testing.assert_array_equal(trace[key], golden[key], err_msg=key)

    @pytest.mark.parametrize("hidden_drift", [False, True])
    def test_steps_bit_equal_to_jax_env(self, hidden_drift):
        envs = [pkg.PoseToyEnv(hidden_drift=hidden_drift, seed=5)
                for pkg in (jax_pose_env, pose_env)]
        action = np.array([0.25, -0.5], np.float32)
        for episode in range(4):
            if episode % 2:
                for env in envs:
                    env.reset_task()
            for env in envs:
                env.set_new_pose()
            want, got = (env.reset() for env in envs)
            np.testing.assert_array_equal(got, want)
            want, got = (env.step(action) for env in envs)
            assert got[1] == want[1] and got[2] is want[2] is True
            np.testing.assert_array_equal(got[3]["target_pose"], want[3]["target_pose"])

    def test_episode_contract(self):
        env = pose_env.PoseToyEnv(seed=0)
        obs = env.reset()
        assert obs.shape == (64, 64, 3) and obs.dtype == np.uint8
        _, reward, done, debug = env.step(np.zeros(2))
        assert done is True and reward <= 0.0
        assert debug["target_pose"].shape == (2,)
        _, best_reward, _, _ = env.step(debug["target_pose"])
        assert best_reward == pytest.approx(0.0, abs=1e-5)

    def test_random_policy(self):
        policy = pose_env.PoseEnvRandomPolicy(seed=0)
        want, _ = jax_pose_env.PoseEnvRandomPolicy(seed=0).sample_action(None, 0.0)
        action, _ = policy.sample_action(None, 0.0)
        np.testing.assert_array_equal(action, want)
        assert np.all(np.abs(action) <= 1.0) and policy.global_step == 0
        assert policy.restore()


def _decode(jpeg: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(jpeg))).astype(np.int64)


@pytest.mark.parametrize("threshold", [None, -0.5])
def test_episode_to_transitions_matches_jax_field_by_field(threshold):
    from tensor2robot_tpu.proto import example_pb2

    env = pose_env.PoseToyEnv(seed=2)
    policy = pose_env.PoseEnvRandomPolicy(seed=3)
    episode = []
    for _ in range(4):
        env.reset_task()
        obs = env.reset()
        action, _ = policy.sample_action(obs, 1.0)
        new_obs, reward, done, debug = env.step(action)
        episode.append((obs, action, reward, new_obs, done, debug))
    want = jax_pose_env.episode_to_transitions_pose_toy(
        episode, binary_success_threshold=threshold)
    got = pose_env.episode_to_transitions_pose_toy(
        episode, binary_success_threshold=threshold)
    assert len(got) == len(want) == 4
    for record, expected, step in zip(got, want, episode):
        parsed = example_pb2.Example.FromString(record).features.feature
        expected = expected.features.feature
        assert set(parsed.keys()) == set(expected.keys())
        for key in ("pose", "reward", "target_pose"):
            np.testing.assert_array_equal(
                np.asarray(parsed[key].float_list.value, np.float32),
                np.asarray(expected[key].float_list.value, np.float32), err_msg=key)
        (image,), (expected_image,) = (parsed["state/image"].bytes_list.value,
                                      expected["state/image"].bytes_list.value)
        decoded, expected_decoded = _decode(image), _decode(expected_image)
        assert decoded.shape == expected_decoded.shape == step[0].shape
        for a, b in ((decoded, expected_decoded), (decoded, step[0].astype(np.int64))):
            gap = np.abs(a - b)
            assert gap.mean() <= ROUNDTRIP[0] and gap.max() <= ROUNDTRIP[1]


class TestTfModules:
    def test_tile_to_match_context(self):
        tiled = tf_modules.tile_to_match_context(torch.ones(2, 3), torch.ones(2, 4, 8))
        assert tiled.shape == (2, 4, 3)

    def test_add_context_broadcasts(self):
        out = tf_modules.add_context(torch.zeros(6, 5, 5, 8), torch.ones(6, 8))
        assert out.shape == (6, 5, 5, 8)
        assert bool(torch.all(out[:, 2, 3, :] == 1.0))

    def test_add_context_validates(self):
        with pytest.raises(ValueError, match="rows"):
            tf_modules.add_context(torch.zeros(4, 5, 5, 8), torch.ones(6, 8))
        with pytest.raises(ValueError, match="Channel"):
            tf_modules.add_context(torch.zeros(6, 5, 5, 4), torch.ones(6, 8))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _numpy_variables(jax_model, features, seed=0):
    """Seeded numpy values in the layout of the JAX model's variables
    (their shapes from jax.eval_shape: a real flax init takes seconds):
    kernels normal / sqrt(fan in), biases normal * 0.05, layer-norm
    scales 1 + normal * 0.1."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jax_model.init_variables(jax.random.PRNGKey(0), features))

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def _images(batch, seed=0):
    return np.random.RandomState(seed).rand(batch, 64, 64, 3).astype(np.float32)


class TestPoseNets:
    def test_regression_forward_and_loss(self):
        from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct

        jax_model = jax_pose_env.PoseEnvRegressionModel(device_type="cpu")
        features = JaxStruct()
        features["state"] = _images(3)
        labels = JaxStruct()
        labels["target_pose"] = np.random.RandomState(1).uniform(-1, 1, (3, 2)).astype(np.float32)
        labels["reward"] = np.array([[1.0], [0.0], [0.5]], np.float32)
        variables = _numpy_variables(jax_model, features)
        outputs, _ = jax_model.inference_network_fn(variables, features, "train")
        loss, _ = jax_model.model_train_fn(features, labels, outputs, "train")

        model = pose_env.PoseEnvRegressionModel()
        network = model.create_network()
        load_flax_variables(network, variables)
        got = network(TensorSpecStruct({"state": torch.from_numpy(features["state"])}),
                      "train")
        for key in ("inference_output", "state_features"):
            np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(outputs[key]),
                                       atol=FWD_TOL, rtol=FWD_TOL, err_msg=key)
        port_labels = TensorSpecStruct({k: torch.from_numpy(v) for k, v in labels.items()})
        got_loss, metrics = model.model_train_fn(None, port_labels, got, "train")
        np.testing.assert_allclose(got_loss.item(), float(loss), atol=FWD_TOL, rtol=FWD_TOL)
        assert "loss/weighted_mse" in metrics
        port_labels["reward"] = torch.zeros(3, 1)
        assert model.model_train_fn(None, port_labels, got, "train")[0].item() == 0.0

    def test_mc_critic_train_and_tiled_predict(self):
        from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct

        jax_model = jax_pose_env.PoseEnvContinuousMCModel(device_type="cpu",
                                                          action_batch_size=5)
        features = JaxStruct()
        features["state/image"] = _images(2)
        features["action/pose"] = np.random.RandomState(2).uniform(-1, 1, (2, 2)).astype(np.float32)
        variables = _numpy_variables(jax_model, features)
        model = pose_env.PoseEnvContinuousMCModel(action_batch_size=5)
        network = model.create_network()
        load_flax_variables(network, variables)
        tiled = JaxStruct()
        tiled["state/image"] = features["state/image"]
        tiled["action/pose"] = np.random.RandomState(3).uniform(-1, 1, (2, 5, 2)).astype(np.float32)
        for batch, mode, shape in ((features, "train", (2,)), (tiled, "predict", (2, 5))):
            want, _ = jax_model.inference_network_fn(variables, batch, mode)
            got = network(TensorSpecStruct(
                {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}), mode)
            assert tuple(got["q_predicted"].shape) == shape
            np.testing.assert_allclose(got["q_predicted"].detach().numpy(),
                                       np.asarray(want["q_predicted"]),
                                       atol=FWD_TOL, rtol=FWD_TOL)
        labels = JaxStruct()
        labels["reward"] = np.array([-0.2, -0.7], np.float32)
        want, _ = jax_model.inference_network_fn(variables, features, "train")
        want_loss, _ = jax_model.model_train_fn(features, labels, want, "train")
        got_loss, _ = model.model_train_fn(
            None, TensorSpecStruct({"reward": torch.from_numpy(labels["reward"])}),
            network(TensorSpecStruct({k: torch.from_numpy(np.asarray(v))
                                      for k, v in features.items()}), "train"), "train")
        np.testing.assert_allclose(got_loss.item(), float(want_loss), atol=FWD_TOL,
                                   rtol=FWD_TOL)

    def test_preprocessors_take_uint8(self):
        model = pose_env.PoseEnvRegressionModel()
        preprocessor = model.preprocessor
        spec = preprocessor.get_in_feature_specification("train")
        assert spec["state"].dtype == torch.uint8
        raw = make_random_numpy(spec, batch_size=2)
        out, _ = preprocessor.preprocess(
            TensorSpecStruct({k: torch.from_numpy(v) for k, v in raw.items()}), None,
            mode="eval")
        assert out["state"].dtype == torch.float32 and float(out["state"].max()) <= 1.0
        critic = pose_env.PoseEnvContinuousMCModel()
        assert (critic.preprocessor.get_in_feature_specification("train")["state/image"].dtype
                == torch.uint8)

    def test_pack_features(self):
        model = pose_env.PoseEnvContinuousMCModel()
        packed = model.pack_features(np.zeros((64, 64, 3), np.uint8), None, 0,
                                     np.zeros((7, 2)))
        assert packed["state/image"].shape == (1, 64, 64, 3)
        assert packed["action/pose"].shape == (1, 7, 2)
        packed = pose_env.PoseEnvRegressionModel().pack_features(
            np.zeros((64, 64, 3), np.uint8), None, 0)
        assert packed["state"].shape == (1, 64, 64, 3)


def _env_batches(count, batch_size=8):
    """Batches of the regression model's raw in-spec from PoseToyEnv
    episodes, rewards relabeled to success (reward > -1) as the collect
    loop's binary_success_threshold does."""
    from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct

    env = pose_env.PoseToyEnv(seed=4)
    policy = pose_env.PoseEnvRandomPolicy(seed=5)
    batches = []
    for _ in range(count):
        images, targets, rewards = [], [], []
        for _ in range(batch_size):
            env.reset_task()
            obs = env.reset()
            action, _ = policy.sample_action(obs, 1.0)
            _, reward, _, debug = env.step(action)
            images.append(obs)
            targets.append(debug["target_pose"])
            rewards.append([float(reward > -1.0)])
        features, labels = JaxStruct(), JaxStruct()
        features["state"] = np.stack(images)
        labels["target_pose"] = np.stack(targets).astype(np.float32)
        labels["reward"] = np.asarray(rewards, np.float32)
        batches.append({"features": features, "labels": labels})
    return batches


def _port_batch(batch):
    return TensorSpecStruct({
        f"{group}/{key}": torch.from_numpy(np.asarray(value))
        for group in ("features", "labels") for key, value in batch[group].items()})


OPTIMIZERS = ("momentum", "adam")
ADAM_LR = 1e-3  # create_adam_optimizer's default in both packages


def _adam_moments(opt_state):
    """optax's Adam count, mu and nu in `opt_state`, or None (momentum)."""
    import optax

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    if not found:
        return None
    return dict(count=int(found[0].count), mu=_host(found[0].mu), nu=_host(found[0].nu))


@pytest.fixture(scope="module")
def jax_train_runs():
    """Two JAX train steps of the regression model with each optimizer
    (Adam is the model's default) from PRNGKey(0) initial variables: the
    variables and Adam moments before and after each step, its loss and
    the gradient it took."""
    from tensor2robot_tpu.models import optimizers as jax_optimizers
    from tensor2robot_tpu.train.train_eval import CompiledModel

    batches = _env_batches(2)
    runs = {}
    for name in OPTIMIZERS:
        model = jax_pose_env.PoseEnvRegressionModel(
            device_type="cpu",
            create_optimizer_fn=getattr(jax_optimizers, f"create_{name}_optimizer"))
        # The same variables as the eager flax init, in a fraction of its time.
        model.init_variables = jax.jit(model.init_variables)
        compiled = CompiledModel(model, donate_state=False)
        state = compiled.init_state(jax.random.PRNGKey(0), batches[0])
        variables = [_host(compiled.export_variables(state))]
        moments = [_adam_moments(state.opt_state)]
        losses = []
        for batch in batches:
            state, metrics = compiled.train_step(state, compiled.shard_batch(batch),
                                                 jax.random.PRNGKey(1))
            losses.append(float(metrics["loss"]))
            variables.append(_host(compiled.export_variables(state)))
            moments.append(_adam_moments(state.opt_state))
        runs[name] = dict(variables=variables, moments=moments, losses=losses)

    def loss_and_grads(variables, batch):
        features, labels = model.preprocessor.preprocess(
            batch["features"], batch["labels"], mode="train", rng=None)

        def loss_fn(params):
            f, l, outputs, _ = model.packed_inference(
                dict(variables, params=params), features, "train", labels=labels)
            return model.model_train_fn(f, l, outputs, "train")[0]

        loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
        return float(loss), _host(grads)

    for run in runs.values():
        run["grads"] = [loss_and_grads(variables, batch)[1] for variables, batch
                        in zip(run["variables"], batches)]
    loss, grads = loss_and_grads(runs["momentum"]["variables"][0], batches[0])
    runs["start"] = dict(loss=loss, grads=grads)
    runs["batches"] = batches
    return runs


def _trainer(name):
    from tensor2robot_tpu_torch.models import optimizers

    model = pose_env.PoseEnvRegressionModel(
        create_optimizer_fn=getattr(optimizers, f"create_{name}_optimizer"))
    return train_eval.Trainer(model, device="cpu")


def test_loss_and_gradient_at_the_start_match_jax(jax_train_runs):
    from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict

    trainer = _trainer("momentum")
    state = trainer.init_state(
        params=flax_variables_to_state_dict(jax_train_runs["momentum"]["variables"][0]))
    batch = infeed.to_device(_port_batch(jax_train_runs["batches"][0]), "cpu")
    loss, _ = trainer.forward_loss(state.network, batch)
    np.testing.assert_allclose(loss.item(), jax_train_runs["start"]["loss"],
                               atol=FWD_TOL, rtol=FWD_TOL)
    loss.backward()
    want = flax_params_to_state_dict(jax_train_runs["start"]["grads"])
    for name, param in state.network.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(param.grad.numpy(), want[name].numpy(),
                                   atol=FWD_TOL * scale + 1e-9, rtol=0, err_msg=name)


def test_two_momentum_steps_match_jax(jax_train_runs):
    """Losses of both steps and every parameter after them within 1e-4."""
    run = jax_train_runs["momentum"]
    trainer = _trainer("momentum")
    state = trainer.init_state(params=flax_variables_to_state_dict(run["variables"][0]))
    for batch, want in zip(jax_train_runs["batches"], run["losses"]):
        metrics = trainer.train_step(state, infeed.to_device(_port_batch(batch), "cpu"))
        np.testing.assert_allclose(float(metrics["loss"]), want, atol=STEP_TOL,
                                   rtol=STEP_TOL)
    expected = flax_variables_to_state_dict(run["variables"][-1])
    got = state.network.state_dict()
    assert set(got) == set(expected)
    for key, value in got.items():
        np.testing.assert_allclose(value.numpy(), expected[key].numpy(),
                                   atol=STEP_TOL, rtol=STEP_TOL, err_msg=key)


def _adam_ill_posed(grads):
    """Per leaf, the elements whose JAX gradient is too small for the two
    packages to agree on Adam's step. Adam divides each element by its own
    magnitude, so a gradient known to within FWD_TOL of its leaf's largest
    (the start gradient's bound above) gives a step known to within
    ADAM_LR * FWD_TOL * largest / |g|: STEP_TOL at |g| = ADAM_LR * FWD_TOL /
    STEP_TOL (1e-4) of the largest. (30% and 43% of the elements lie below
    it at the two steps here, most at an exact 0 in JAX: the units behind
    dead relus, where a 1e-9 in the port steps a full learning rate.)"""
    ratio = ADAM_LR * FWD_TOL / STEP_TOL
    return {key: g.abs() <= ratio * float(g.abs().max()) for key, g in grads.items()}


@pytest.mark.parametrize("step", [0, 1])
def test_adam_steps_match_jax(jax_train_runs, step):
    """Adam (the model's default), step by step: each port step starts from
    JAX's parameters and moments before that step (so the steps before it
    cannot carry an ill-posed element's difference into its gradient).
    The loss, and the first and second moments after the step, within
    1e-4 (moments of their leaf's largest); the parameters within 1e-4
    where the step is well posed, and elsewhere within Adam's bound of
    one step (1.0013 learning rates at the second, bias-corrected step)
    in both packages."""
    from tensor2robot_tpu_torch.utils.jax_params import flax_params_to_state_dict

    run = jax_train_runs["adam"]
    trainer = _trainer("adam")
    before = flax_variables_to_state_dict(run["variables"][step])
    state = trainer.init_state(params=before)
    params = dict(state.network.named_parameters())
    moments = run["moments"][step]
    if moments["count"]:
        mu, nu = (flax_params_to_state_dict(moments[k]) for k in ("mu", "nu"))
        for key, param in params.items():
            state.optimizer.state[param] = dict(
                step=torch.tensor(float(moments["count"])),
                exp_avg=mu[key].clone(), exp_avg_sq=nu[key].clone())
    batch = jax_train_runs["batches"][step]
    metrics = trainer.train_step(state, infeed.to_device(_port_batch(batch), "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), run["losses"][step],
                               atol=STEP_TOL, rtol=STEP_TOL)
    after = run["moments"][step + 1]
    for name, key in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        want = flax_params_to_state_dict(after[key])
        for leaf, param in params.items():
            scale = float(want[leaf].abs().max())
            np.testing.assert_allclose(
                state.optimizer.state[param][name].numpy(), want[leaf].numpy(),
                atol=STEP_TOL * scale + 1e-12, rtol=0, err_msg=f"{name} {leaf}")
    ill_posed = _adam_ill_posed(flax_params_to_state_dict(run["grads"][step]))
    expected = flax_variables_to_state_dict(run["variables"][step + 1])
    got = state.network.state_dict()
    assert set(got) == set(expected)
    for key, value in got.items():
        mask = ill_posed.get(key, torch.zeros(value.shape, dtype=torch.bool))
        for moved in (value, expected[key]):
            assert float(torch.where(mask, (moved - before[key]).abs(), 0.0).max()) <= (
                1.002 * ADAM_LR), key
        np.testing.assert_allclose(value[~mask].numpy(), expected[key][~mask].numpy(),
                                   atol=STEP_TOL, rtol=STEP_TOL, err_msg=key)


class TestVisionLayers:
    def test_high_res_tower_matches_jax(self):
        """ImagesToFeaturesHighResNet (no model uses it yet) at 128x128
        with 3 blocks: nearest resizes of 12x12 and 4x4 maps onto 29x29."""
        from tensor2robot_tpu.layers import vision_layers as jax_layers
        from tensor2robot_tpu_torch.layers import vision_layers

        images = _images(2)[:, :, :, :].repeat(2, axis=1).repeat(2, axis=2)
        jax_net = jax_layers.ImagesToFeaturesHighResNet(num_blocks=3)
        variables = _numpy_variables_of(jax_net, images)
        want, want_extra = jax_net.apply(variables, images)
        net = vision_layers.ImagesToFeaturesHighResNet(num_blocks=3)
        load_flax_variables(net, variables)
        got, extra = net(torch.from_numpy(images))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=FWD_TOL, rtol=FWD_TOL)
        assert extra["softmax"].shape == want_extra["softmax"].shape

    def test_film_tower_matches_jax(self):
        from tensor2robot_tpu.layers import vision_layers as jax_layers
        from tensor2robot_tpu_torch.layers import vision_layers

        images = _images(2)
        film = np.random.RandomState(7).standard_normal((2, 2 * 3 * 8)).astype(np.float32)
        kwargs = dict(num_blocks=3, num_channels_per_block=8, num_output_maps=4)
        jax_net = jax_layers.ImagesToFeaturesNet(**kwargs)
        variables = _numpy_variables_of(jax_net, images, film_output_params=film)
        want, _ = jax_net.apply(variables, images, film_output_params=film)
        net = vision_layers.ImagesToFeaturesNet(**kwargs)
        load_flax_variables(net, variables)
        got, _ = net(torch.from_numpy(images),
                     film_output_params=torch.from_numpy(film))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=FWD_TOL, rtol=FWD_TOL)
        with pytest.raises(ValueError, match="FiLM params shape"):
            net(torch.from_numpy(images), film_output_params=torch.zeros(2, 5))


def _numpy_variables_of(flax_module, *args, **kwargs):
    class _Init:
        def init_variables(self, rng, features):
            return flax_module.init(rng, *args, **kwargs)

    return _numpy_variables(_Init(), None)
