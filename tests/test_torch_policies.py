"""The port's policies (policies/policies.py) against the JAX package's.

  * Twins of the JAX policy tests (tests/test_policies.py): the argmax of
    a quadratic critic served from the port's export, by the numpy
    engine and by JitCEMPolicy (which runs its loop eagerly here: CUDA
    graphs need the card; chip_smoke.py's policy phase holds the graph
    against the eager loop there); a two-leaf action; an int8 export;
    the fallback to the numpy engine; the regression, exploration and
    switch policies.
  * CEMPolicy over the same numpy critic, same seed, bit-equal to the
    JAX package's CEMPolicy (every population it scores and its action).
  * The Grasping44 critic at 96x96, num_convs (2, 2, 1), exported with
    action_batch_size=8 by both packages from the same (converted)
    weights: the resolved action leaves equal JAX's in spec order, and
    the Q of one fixed population agrees within 1e-5 abs + rel through
    the port's predictor and through JitCEMPolicy's objective.
"""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from tensor2robot_tpu.policies import CEMPolicy as JaxCEMPolicy
from tensor2robot_tpu_torch.export import DefaultExportGenerator, save_exported_model
from tensor2robot_tpu_torch.models.base_models import CriticModel, tile_actions_for_cem
from tensor2robot_tpu_torch.policies import (
    CEMPolicy,
    JitCEMPolicy,
    LSTMCEMPolicy,
    OUExploreRegressionPolicy,
    PerEpisodeSwitchPolicy,
    RegressionPolicy,
    ScheduledExplorationRegressionPolicy,
    SequentialRegressionPolicy,
)
from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
from tensor2robot_tpu_torch.predictors.abstract_predictor import AbstractPredictor
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct

_POP = 32  # CEM population == exported action_batch_size
Q_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# -- small critics whose q is computable in closed form --------------------------


class _QuadraticNet(nn.Module):
    """q = -(action - mean(state))^2 + bias, one action leaf `a`."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, features, mode):
        state, action = features["state/obs"], features["action/a"]
        if action.ndim == 3:  # predict-mode population [b, n, 1]
            tiled, action = tile_actions_for_cem(TensorSpecStruct({"obs": state}), action)
            state = tiled["obs"]
        target = state.mean(dim=-1, keepdim=True)
        return {"q_predicted": -((action - target) ** 2).sum(dim=-1) + self.bias[0]}


class _TwoLeafNet(nn.Module):
    """q = -(a - s0)^2 - (b - s1)^2 through a 1x1 linear layer (so an int8
    export quantizes something) over a TWO-leaf action spec."""

    def __init__(self):
        super().__init__()
        self.gain = nn.Linear(1, 1, bias=False)

    def forward(self, features, mode):
        state, a, b = features["state/obs"], features["action/a"], features["action/b"]
        if a.ndim == 3:
            tiled, action = tile_actions_for_cem(
                TensorSpecStruct({"obs": state}), torch.cat([a, b], dim=-1))
            state = tiled["obs"]
            a, b = action[..., :2], action[..., 2:]
        q = (-((a - state[..., :1]) ** 2).sum(dim=-1)
             - ((b - state[..., 1:]) ** 2).sum(dim=-1))
        return {"q_predicted": self.gain(q[..., None])[..., 0]}


class _Critic(CriticModel):
    def __init__(self, net_cls, action_leaves, **kwargs):
        super().__init__(**kwargs)
        self._net_cls, self._leaves = net_cls, action_leaves

    def create_network(self):
        return self._net_cls()

    def init_network(self, generator=None, device="cuda"):
        network = self.create_network().to(device)
        if isinstance(network, _TwoLeafNet):
            with torch.no_grad():
                network.gain.weight.fill_(1.0)
        return network

    def get_state_specification(self):
        return TensorSpecStruct(
            obs=ExtendedTensorSpec(shape=(2,), dtype=np.float32, name="obs"))

    def get_action_specification(self):
        spec = TensorSpecStruct()
        for name, size in self._leaves:
            spec[name] = ExtendedTensorSpec(shape=(size,), dtype=np.float32, name=name)
        return spec


def _export_critic(root, net_cls, leaves, quantize=False, population=_POP, program=True):
    model = _Critic(net_cls, leaves, action_batch_size=population)
    state = model.init_network(device="cpu").state_dict()
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)
    save_exported_model(
        str(root), variables=state, feature_spec=generator.serving_input_spec(),
        global_step=1, quantize_weights=quantize,
        serving_module=generator.create_serving_fn(
            state, device=torch.device("cpu"), quantize_weights=quantize),
        example_features=generator.create_example_features(),
        export_program_file=program,
    )
    predictor = ExportedSavedModelPredictor(
        export_dir=str(root), t2r_model=model, device="cpu")
    assert predictor.restore()
    return predictor


@pytest.fixture(scope="module")
def critic_predictor(tmp_path_factory):
    return _export_critic(tmp_path_factory.mktemp("critic"), _QuadraticNet, [("a", 1)])


@pytest.fixture(scope="module")
def two_leaf_predictor(tmp_path_factory):
    return _export_critic(
        tmp_path_factory.mktemp("two_leaf"), _TwoLeafNet, [("a", 2), ("b", 1)])


class TestCEMPolicy:
    def test_cem_finds_argmax_action(self, critic_predictor):
        policy = CEMPolicy(critic_predictor, action_size=1, cem_samples=_POP,
                           cem_iterations=5, seed=0)
        action = policy.SelectAction({"state/obs": np.array([0.2, 0.8], np.float32)})
        np.testing.assert_allclose(action, [0.5], atol=0.1)

    def test_sample_action_interface(self, critic_predictor):
        policy = CEMPolicy(critic_predictor, action_size=1, cem_samples=_POP, seed=0)
        action, debug = policy.sample_action(
            {"state/obs": np.zeros(2, np.float32)}, explore_prob=1.0)
        assert action.shape == (1,) and action.dtype == np.float32
        assert isinstance(debug, dict)


class _NumpyCritic:
    """A host critic both packages' CEMPolicy can score: q = -(a - t)^2
    summed over a two-leaf action, recording every population."""

    def __init__(self, specs=None):
        """`specs`: the package whose spec classes to answer with (the
        port's by default)."""
        self.populations = []
        self._specs = specs

    def get_feature_specification(self):
        struct, leaf = TensorSpecStruct, ExtendedTensorSpec
        if self._specs is not None:
            struct, leaf = self._specs.TensorSpecStruct, self._specs.ExtendedTensorSpec
        spec = struct()
        spec["state/obs"] = leaf(shape=(3,), dtype=np.float32, name="obs")
        spec["action/a"] = leaf(shape=(16, 2), dtype=np.float32, name="a")
        spec["action/b"] = leaf(shape=(16, 1), dtype=np.float32, name="b")
        return spec

    def predict(self, batch):
        action = np.concatenate([batch["action/a"], batch["action/b"]], axis=-1)[0]
        self.populations.append(action.copy())
        target = np.asarray(batch["state/obs"])[0]
        return {"q_predicted": -np.sum((action - target) ** 2, axis=-1)[None]}


@pytest.mark.parametrize("seed", [0, 7])
def test_cem_policy_bit_equal_to_jax_package(seed):
    state = {"state/obs": np.array([0.4, -0.3, 0.75], np.float32)}
    runs = []
    from tensor2robot_tpu import specs as jax_specs

    for cls, specs in ((JaxCEMPolicy, jax_specs), (CEMPolicy, None)):
        critic = _NumpyCritic(specs)
        policy = cls(critic, action_size=3, cem_samples=16, cem_iterations=4,
                     action_low=-0.5, action_high=1.0, seed=seed)
        runs.append((policy.SelectAction(state), critic.populations,
                     policy._resolve_action_leaves()))
    (want, want_pops, want_leaves), (got, got_pops, got_leaves) = runs
    assert got_leaves == want_leaves == [("action/a", 2), ("action/b", 1)]
    assert len(got_pops) == len(want_pops) == 4
    for g, w in zip(got_pops, want_pops):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got, want)


class TestJitCEMPolicy:
    def test_finds_argmax_action(self, critic_predictor):
        policy = JitCEMPolicy(critic_predictor, action_size=1, cem_samples=_POP,
                              cem_iterations=5, seed=0)
        action = policy.SelectAction({"state/obs": np.array([0.2, 0.8], np.float32)})
        np.testing.assert_allclose(action, [0.5], atol=0.1)
        # The program path ran (eagerly: the program is on the CPU).
        assert policy.eager_selects == 1 and policy.graph_replays == 0
        assert policy._source is critic_predictor.loaded_model
        rng = np.random.RandomState(1)
        for _ in range(3):
            state = rng.uniform(-1, 1, 2).astype(np.float32)
            action = policy.SelectAction({"state/obs": state})
            assert -1.0 <= float(action[0]) <= 1.0
            # last_q is the critic's Q of the returned action.
            q = critic_predictor.predict({
                "state/obs": state[None],
                "action/a": np.repeat(action[None, None], _POP, axis=1)})
            np.testing.assert_allclose(policy.last_q, q["q_predicted"][0],
                                       atol=Q_TOL, rtol=Q_TOL)
        assert policy.eager_selects == 4

    def test_seed_replays_the_same_selection(self, critic_predictor):
        policy = JitCEMPolicy(critic_predictor, action_size=1, cem_samples=_POP, seed=3)
        state = {"state/obs": np.array([0.1, -0.4], np.float32)}
        first = policy.SelectAction(state)
        policy.SelectAction(state)  # advances the noise stream
        policy.seed(3)
        np.testing.assert_array_equal(policy.SelectAction(state), first)

    def test_falls_back_without_a_program(self, tmp_path):
        """An export without a program (served from model code) uses the
        numpy engine, as JAX's JitCEMPolicy does without StableHLO."""
        predictor = _export_critic(tmp_path, _QuadraticNet, [("a", 1)], program=False)
        assert not predictor.loaded_model.has_program
        policy = JitCEMPolicy(predictor, action_size=1, cem_samples=_POP,
                              cem_iterations=5, seed=0)
        action = policy.SelectAction({"state/obs": np.array([0.4, 0.6], np.float32)})
        np.testing.assert_allclose(action, [0.5], atol=0.1)
        assert policy._source is None and policy.eager_selects == 0

    def test_falls_back_for_a_predictor_without_loaded_model(self):
        critic = _NumpyCritic()
        policy = JitCEMPolicy(critic, action_size=3, cem_samples=16, seed=0)
        policy.SelectAction({"state/obs": np.zeros(3, np.float32)})
        assert len(critic.populations) == 3 and policy._source is None

    def test_population_mismatch_rejected_at_build(self, tmp_path):
        predictor = _export_critic(tmp_path, _QuadraticNet, [("a", 1)], population=8)
        policy = JitCEMPolicy(predictor, action_size=1, cem_samples=_POP, seed=0)
        with pytest.raises(ValueError, match="action_batch_size=32"):
            policy.SelectAction({"state/obs": np.zeros(2, np.float32)})

    def test_rebuilds_for_a_new_version(self, tmp_path):
        import os
        import shutil

        root = tmp_path / "root"
        source = _export_critic(tmp_path / "src", _QuadraticNet, [("a", 1)])
        src_dir = source.loaded_model.export_dir
        os.makedirs(root)
        shutil.copytree(src_dir, root / "100")
        predictor = ExportedSavedModelPredictor(export_dir=str(root), device="cpu")
        assert predictor.restore()
        policy = JitCEMPolicy(predictor, action_size=1, cem_samples=_POP, seed=0)
        state = {"state/obs": np.array([0.2, 0.8], np.float32)}
        policy.SelectAction(state)
        first = policy._source
        shutil.copytree(src_dir, root / "200")
        assert predictor.restore() and predictor.loaded_model is not first
        np.testing.assert_allclose(policy.SelectAction(state), [0.5], atol=0.1)
        assert policy._source is predictor.loaded_model


class TestMultiLeafActionCEM:
    def _assert_optimum(self, policy):
        action = policy.SelectAction({"state/obs": np.array([0.4, -0.3], np.float32)})
        assert action.shape == (3,)
        np.testing.assert_allclose(action[:2], [0.4, 0.4], atol=0.12)
        np.testing.assert_allclose(action[2:], [-0.3], atol=0.12)

    def test_numpy_engine(self, two_leaf_predictor):
        self._assert_optimum(CEMPolicy(two_leaf_predictor, action_size=3,
                                       cem_samples=_POP, cem_iterations=8, seed=0))

    def test_jit_engine(self, two_leaf_predictor):
        policy = JitCEMPolicy(two_leaf_predictor, action_size=3, cem_samples=_POP,
                              cem_iterations=8, seed=0)
        self._assert_optimum(policy)
        assert policy.eager_selects == 1

    def test_jit_engine_over_quantized_export(self, tmp_path):
        predictor = _export_critic(tmp_path, _TwoLeafNet, [("a", 2), ("b", 1)],
                                   quantize=True)
        assert predictor.loaded_model.metadata["weights_int8"]
        policy = JitCEMPolicy(predictor, action_size=3, cem_samples=_POP,
                              cem_iterations=8, seed=0)
        self._assert_optimum(policy)
        assert policy.eager_selects == 1

    def test_action_size_mismatch_rejected(self, two_leaf_predictor):
        policy = CEMPolicy(two_leaf_predictor, action_size=5, cem_samples=_POP, seed=0)
        with pytest.raises(ValueError, match="sum to 3"):
            policy.SelectAction({"state/obs": np.zeros(2, np.float32)})


# -- Grasping44 exported by both packages --------------------------------------------

GRASPING = dict(image_size=(96, 96), num_convs=(2, 2, 1), action_batch_size=8)
GRASPING_NAME = "Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom"


def _scaled_variables(variables, seed=0):
    """Seeded numpy values of a trained critic's scale in the layout of
    `variables`: kernels normal * sqrt(2 / fan in), biases and batch-norm
    means normal * 0.05, scales 1 + normal * 0.1, variances uniform in
    [0.5, 1.5]. The package's own init (std 0.01 kernels, zero biases)
    gives logits of ~1e-7, which any absolute tolerance would pass."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = getattr(path[-1], "key", ""), np.shape(leaf)
        if name == "kernel":
            value = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif name == "scale":
            value = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            value = rng.uniform(0.5, 1.5, shape)
        else:
            value = 0.05 * rng.standard_normal(shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, variables)


@pytest.fixture(scope="module")
def grasping(tmp_path_factory):
    from tensor2robot_tpu.export import saved_model as jax_saved_model
    from tensor2robot_tpu.export.export_generators import (
        DefaultExportGenerator as JaxExportGenerator,
    )
    from tensor2robot_tpu.predictors import (
        ExportedSavedModelPredictor as JaxExportedPredictor,
    )
    from tensor2robot_tpu.research.qtopt import t2r_models as jax_qtopt
    from tensor2robot_tpu.specs import make_random_numpy as jax_random_numpy
    from tensor2robot_tpu.train.train_eval import CompiledModel
    from tensor2robot_tpu_torch.research.qtopt import t2r_models
    from tensor2robot_tpu_torch.utils.jax_params import flax_variables_to_state_dict

    root = tmp_path_factory.mktemp("grasping")
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("T2R_AOT_EXPORT", "0")
        patch.setenv("T2R_SERVE_AOT", "0")
        jax_model = getattr(jax_qtopt, GRASPING_NAME)(**GRASPING)
        preprocessor = jax_model.preprocessor
        raw = jax_random_numpy(preprocessor.get_in_feature_specification("predict"),
                               batch_size=2, seed=4)
        features, _ = preprocessor.preprocess(raw, None, mode="predict", rng=None)
        variables = _scaled_variables(
            dict(jax_model.init_variables(jax.random.PRNGKey(0), features)))
        generator = JaxExportGenerator()
        generator.set_specification_from_model(jax_model)
        jax_saved_model.save_exported_model(
            str(root / "jax"), variables=variables,
            feature_spec=generator.serving_input_spec(), global_step=3,
            predict_fn=generator.create_serving_fn(
                CompiledModel(jax_model, donate_state=False), variables),
            example_features=generator.create_example_features())
        jax_predictor = JaxExportedPredictor(export_dir=str(root / "jax"))
        assert jax_predictor.restore()
        model = getattr(t2r_models, GRASPING_NAME)(**GRASPING)
        state = flax_variables_to_state_dict(variables)
        port_generator = DefaultExportGenerator()
        port_generator.set_specification_from_model(model)
        save_exported_model(
            str(root / "port"), variables=state,
            feature_spec=port_generator.serving_input_spec(), global_step=3,
            serving_module=port_generator.create_serving_fn(
                state, device=torch.device("cpu")),
            example_features=port_generator.create_example_features())
        predictor = ExportedSavedModelPredictor(export_dir=str(root / "port"),
                                                device="cpu")
        assert predictor.restore()
        yield dict(jax=jax_predictor, port=predictor)


def _grasping_state(predictor):
    from tensor2robot_tpu_torch.specs import make_random_numpy

    spec = predictor.get_feature_specification()
    batch = make_random_numpy(spec, batch_size=1, seed=0)
    return {k: v[0] for k, v in batch.items() if k.startswith("state")}


def test_grasping_leaf_order_matches_jax(grasping):
    got = CEMPolicy(grasping["port"], action_size=10, cem_samples=8)
    want = JaxCEMPolicy(grasping["jax"], action_size=10, cem_samples=8)
    assert got._resolve_action_leaves() == want._resolve_action_leaves()
    assert [k for k, _ in got._resolve_action_leaves()] == [
        f"action/{name}" for name in (
            "world_vector", "vertical_rotation", "close_gripper", "open_gripper",
            "terminate_episode", "gripper_closed", "height_to_bottom")]


def test_grasping_population_q_matches_jax(grasping):
    state = _grasping_state(grasping["port"])
    population = np.random.RandomState(1).uniform(-1, 1, (8, 10)).astype(np.float32)
    policy = JitCEMPolicy(grasping["port"], action_size=10, cem_samples=8, seed=0)
    leaves = policy._resolve_action_leaves()
    batch = {k: v[None] for k, v in state.items()}
    offset = 0
    for key, size in leaves:
        batch[key] = population[None, :, offset:offset + size]
        offset += size
    want = np.asarray(grasping["jax"].predict(batch)["q_predicted"]).reshape(-1)
    # The population's Q must spread far beyond the tolerance, or zeros or
    # a shuffled action split would pass.
    assert np.ptp(want) > 1e3 * Q_TOL * (1.0 + np.abs(want).max()), want
    got = grasping["port"].predict(batch)["q_predicted"].reshape(-1)
    np.testing.assert_allclose(got, want, atol=Q_TOL, rtol=Q_TOL)
    # The same population through the jit policy's own objective.
    loaded = grasping["port"].loaded_model
    policy._prepare(loaded)
    policy._load_features(state)
    scored = policy._objective(loaded, leaves)(torch.from_numpy(population))
    np.testing.assert_allclose(scored.numpy(), want, atol=Q_TOL, rtol=Q_TOL)


def test_grasping_jit_select_is_in_box_and_rescored(grasping):
    predictor = grasping["port"]
    state = _grasping_state(predictor)
    policy = JitCEMPolicy(predictor, action_size=10, cem_samples=8, cem_iterations=3,
                          seed=0)
    action = policy.SelectAction(state)
    assert action.shape == (10,) and np.all(np.abs(action) <= 1.0)
    batch = {k: v[None] for k, v in state.items()}
    offset = 0
    for key, size in policy._resolve_action_leaves():
        batch[key] = np.repeat(action[None, None, offset:offset + size], 8, axis=1)
        offset += size
    q = predictor.predict(batch)["q_predicted"].reshape(-1)
    np.testing.assert_allclose(q, policy.last_q, atol=Q_TOL, rtol=Q_TOL)


# -- regression policies over a fake predictor -----------------------------------------


class _FakeRegressionPredictor(AbstractPredictor):
    """Action = obs[:1] * 2, counts restores."""

    def __init__(self):
        self.restores = 0
        self._step = 0

    def predict(self, features):
        x = np.asarray(features["x"])
        if x.ndim == 3:  # [b, time, d] sequential variant: use newest frame
            x = x[:, -1]
        return {"inference_output": x[:, :1] * 2.0}

    def get_feature_specification(self):
        spec = TensorSpecStruct()
        spec["x"] = ExtendedTensorSpec(shape=(3,), dtype=np.float32, name="x")
        return spec

    def restore(self, is_async: bool = False):
        self.restores += 1
        self._step += 10
        return True

    def init_randomly(self, generator=None):
        self._step = 0

    @property
    def model_version(self):
        return self._step

    @property
    def global_step(self):
        return self._step

    @property
    def model_path(self):
        return None


class TestRegressionPolicies:
    def test_regression_policy_bare_array_obs(self):
        policy = RegressionPolicy(_FakeRegressionPredictor())
        action = policy.SelectAction(np.array([1.5, 0.0, 0.0], np.float32))
        np.testing.assert_allclose(action, [3.0])

    def test_sequential_policy_stacks_history(self):
        policy = SequentialRegressionPolicy(_FakeRegressionPredictor(), history_length=3)
        policy.reset()
        for value in (1.0, 2.0, 3.0):
            action = policy.SelectAction(np.array([value, 0, 0], np.float32))
        np.testing.assert_allclose(action, [6.0])  # newest frame * 2

    def test_ou_explore_adds_noise_only_when_exploring(self):
        policy = OUExploreRegressionPolicy(_FakeRegressionPredictor())
        policy.seed(0)
        obs = np.array([1.0, 0, 0], np.float32)
        greedy, _ = policy.sample_action(obs, explore_prob=0.0)
        np.testing.assert_allclose(greedy, [2.0])
        noisy, debug = policy.sample_action(obs, explore_prob=1.0)
        assert not np.allclose(noisy, [2.0])
        assert "ou_noise" in debug

    def test_scheduled_exploration_decays(self):
        predictor = _FakeRegressionPredictor()
        policy = ScheduledExplorationRegressionPolicy(
            predictor, initial_stddev=0.5, final_stddev=0.0, decay_steps=20)
        assert policy.current_stddev() == pytest.approx(0.5)
        predictor.restore()  # step 10
        assert policy.current_stddev() == pytest.approx(0.25)
        predictor.restore()  # step 20
        assert policy.current_stddev() == pytest.approx(0.0)
        predictor.restore()  # step 30: clamped
        assert policy.current_stddev() == pytest.approx(0.0)

    def test_per_episode_switch(self):
        greedy = RegressionPolicy(_FakeRegressionPredictor())
        explore = OUExploreRegressionPolicy(_FakeRegressionPredictor())
        switch = PerEpisodeSwitchPolicy(explore, greedy)
        switch.seed(0)
        switch.reset(explore_prob=0.0)
        assert switch.active_policy is greedy
        switch.reset(explore_prob=1.0)
        assert switch.active_policy is explore

    def test_per_episode_switch_constructor_prob_survives_bare_reset(self):
        greedy = RegressionPolicy(_FakeRegressionPredictor())
        explore = OUExploreRegressionPolicy(_FakeRegressionPredictor())
        switch = PerEpisodeSwitchPolicy(explore, greedy, explore_prob=1.0)
        switch.seed(0)
        switch.reset()
        assert switch.active_policy is explore

    @pytest.mark.parametrize("policy_cls", ["OUExploreRegressionPolicy",
                                            "ScheduledExplorationRegressionPolicy"])
    def test_exploration_noise_bit_equal_to_jax_package(self, policy_cls):
        from tensor2robot_tpu import policies as jax_policies
        from tensor2robot_tpu_torch import policies as port_policies

        obs = {"x": np.array([0.3, 0, 0], np.float32)}
        runs = []
        for module in (jax_policies, port_policies):
            predictor = _FakeRegressionPredictor()
            predictor.restore()
            policy = getattr(module, policy_cls)(predictor)
            policy.seed(11)
            runs.append([policy.sample_action(obs, explore_prob=0.5)[0]
                         for _ in range(6)])
        for got, want in zip(*reversed(runs)):
            np.testing.assert_array_equal(got, want)


class _RecurrentCritic(_NumpyCritic):
    """Adds a hidden state: state_output = the chosen action's sum."""

    def predict(self, batch):
        out = super().predict(batch)
        if np.asarray(batch["action/a"]).shape[1] == 1:  # the advancing pass
            out["state_output"] = np.asarray(batch["action/a"]).sum(axis=(1, 2))
        return out


def test_lstm_cem_policy_carries_hidden_state():
    critic = _RecurrentCritic()
    policy = LSTMCEMPolicy(critic, action_size=3, cem_samples=16, seed=0)
    state = {"state/obs": np.array([0.2, 0.1, -0.2], np.float32)}
    action = policy.SelectAction(state)
    np.testing.assert_allclose(policy._hidden, action[:2].sum(), rtol=1e-6)
    policy.reset()
    assert policy._hidden is None
