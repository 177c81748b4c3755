"""The port's config registry (config/registry.py): the twin of the JAX
package's tests/test_config.py on the port's own copy, and the same gin
text binding either package under the same registered names."""

import numpy as np
import pytest

from tensor2robot_tpu_torch import config as cfg

@pytest.fixture(autouse=True)
def clean_registry():
    cfg.clear_config()
    yield
    cfg.clear_config()


@cfg.configurable
def make_widget(size=1, color="red", factory=None):
    if factory is not None:
        return factory, size
    return (size, color)


@cfg.configurable("named_thing")
def thing_fn(value=0):
    return value


@cfg.configurable
class Gadget:
    def __init__(self, power=5, name="g"):
        self.power = power
        self.name = name


class TestBindings:
    def test_simple_binding(self):
        cfg.parse_config("make_widget.size = 42")
        assert make_widget() == (42, "red")

    def test_explicit_kwargs_win(self):
        cfg.parse_config("make_widget.size = 42")
        assert make_widget(size=7) == (7, "red")

    def test_named_configurable(self):
        cfg.parse_config("named_thing.value = 3")
        assert thing_fn() == 3

    def test_class_binding_and_isinstance(self):
        cfg.parse_config("Gadget.power = 99")
        g = Gadget()
        assert g.power == 99 and g.name == "g"
        assert isinstance(g, Gadget)

    def test_unknown_param_rejected(self):
        cfg.parse_config("make_widget.nope = 1")
        with pytest.raises(cfg.ConfigError, match="nope"):
            make_widget()

    def test_bind_parameter_runtime(self):
        cfg.bind_parameter("make_widget.color", "blue")
        assert make_widget() == (1, "blue")

    def test_query_parameter(self):
        cfg.bind_parameter("make_widget.size", 5)
        assert cfg.query_parameter("make_widget.size") == 5


class TestValues:
    def test_literals(self):
        cfg.parse_config("""
make_widget.size = -3
make_widget.color = 'green'
""")
        assert make_widget() == (-3, "green")

    def test_containers_multiline(self):
        cfg.parse_config("""
make_widget.size = [1,
                    2,
                    3]
""")
        assert make_widget()[0] == [1, 2, 3]

    def test_macro(self):
        cfg.parse_config("""
SIZE = 11
make_widget.size = %SIZE
""")
        assert make_widget() == (11, "red")

    def test_reference_uncalled(self):
        cfg.parse_config("make_widget.factory = @named_thing")
        factory, _ = make_widget()
        assert factory() == 0

    def test_reference_called(self):
        cfg.parse_config("""
named_thing.value = 9
make_widget.factory = @named_thing()
""")
        factory_result, _ = make_widget()
        assert factory_result == 9


class TestScopes:
    def test_scoped_binding(self):
        cfg.parse_config("""
make_widget.size = 1
train/make_widget.size = 100
""")
        assert make_widget() == (1, "red")
        with cfg.config_scope("train"):
            assert make_widget() == (100, "red")
        assert make_widget() == (1, "red")

    def test_scoped_reference(self):
        cfg.parse_config("""
named_thing.value = 1
s1/named_thing.value = 2
make_widget.factory = @s1/named_thing()
""")
        result, _ = make_widget()
        assert result == 2


class TestFiles:
    def test_include(self, tmp_path):
        base = tmp_path / "base.gin"
        base.write_text("make_widget.size = 5\n")
        main = tmp_path / "main.gin"
        main.write_text(f"include 'base.gin'\nmake_widget.color = 'black'\n")
        cfg.parse_config_file(str(main))
        assert make_widget() == (5, "black")

    def test_parse_config_files_and_bindings(self, tmp_path):
        f = tmp_path / "a.gin"
        f.write_text("make_widget.size = 2\n")
        cfg.parse_config_files_and_bindings(
            [str(f)], ["make_widget.color = 'x'"]
        )
        assert make_widget() == (2, "x")

    def test_comments_ignored(self):
        cfg.parse_config("""
# full line comment
make_widget.size = 4  # trailing comment
""")
        assert make_widget() == (4, "red")


class TestOperativeConfig:
    def test_records_actual_values(self, tmp_path):
        cfg.parse_config("make_widget.size = 8")
        make_widget(color="used")
        text = cfg.operative_config_str()
        assert "make_widget.size = 8" in text
        assert "make_widget.color = 'used'" in text
        path = cfg.save_operative_config(str(tmp_path))
        assert "make_widget.size = 8" in open(path).read()

    def test_external_configurable(self):
        def third_party(a=1):
            return a

        wrapped = cfg.external_configurable(third_party, "tp")
        cfg.parse_config("tp.a = 77")
        assert wrapped() == 77


# -- one gin text, either package ----------------------------------------------------

SHARED_NAMES = (
    "CEMPolicy", "JitCEMPolicy", "LSTMCEMPolicy", "RegressionPolicy",
    "SequentialRegressionPolicy", "OUExploreRegressionPolicy",
    "ScheduledExplorationRegressionPolicy", "PerEpisodeSwitchPolicy",
    "TFRecordReplayWriter", "collect_eval_loop", "PoseToyEnv",
    "PoseEnvRandomPolicy", "episode_to_transitions_pose_toy",
    "PoseEnvContinuousMCModel", "PoseEnvRegressionModel",
)

POSE_GIN = """
SEED = 123
PoseToyEnv.hidden_drift = True
PoseToyEnv.seed = %SEED
PoseEnvRandomPolicy.seed = 7
"""


def _packages():
    import tensor2robot_tpu.config as jax_cfg
    import tensor2robot_tpu.policies  # noqa: F401 — registers the policies
    import tensor2robot_tpu.research.pose_env  # noqa: F401
    import tensor2robot_tpu.utils.continuous_collect_eval  # noqa: F401
    import tensor2robot_tpu.utils.writer  # noqa: F401
    import tensor2robot_tpu_torch.policies  # noqa: F401
    import tensor2robot_tpu_torch.research.pose_env  # noqa: F401
    import tensor2robot_tpu_torch.utils.continuous_collect_eval  # noqa: F401
    import tensor2robot_tpu_torch.utils.writer  # noqa: F401

    return jax_cfg, cfg


def _defined_in(target) -> str:
    """The module of a registered callable (a registered class is a
    subclass made by the registry: its base is the class itself)."""
    if isinstance(target, type):
        return target.__mro__[1].__module__
    return target.__module__


@pytest.mark.parametrize("name", SHARED_NAMES)
def test_ported_configurables_keep_their_names(name):
    jax_cfg, port_cfg = _packages()
    jax_target = jax_cfg.get_configurable(name)
    port_target = port_cfg.get_configurable(name)
    assert _defined_in(port_target).startswith("tensor2robot_tpu_torch.")
    assert _defined_in(jax_target).startswith("tensor2robot_tpu.")
    assert jax_target.__name__ == port_target.__name__


def test_one_gin_text_binds_either_package():
    jax_cfg, port_cfg = _packages()
    rollouts, operative = [], []
    for registry in (jax_cfg, port_cfg):
        registry.clear_config()
        try:
            registry.parse_config(POSE_GIN)
            env = registry.get_configurable("PoseToyEnv")()
            policy = registry.get_configurable("PoseEnvRandomPolicy")()
            obs = env.reset()
            action, _ = policy.sample_action(obs, 1.0)
            rollouts.append((obs, action, env.step(action)[1]))
            operative.append(registry.operative_config_str())
        finally:
            registry.clear_config()
    (want_obs, want_action, want_reward), (obs, action, reward) = rollouts
    np.testing.assert_array_equal(obs, want_obs)
    np.testing.assert_array_equal(action, want_action)
    assert reward == want_reward
    assert operative[0] == operative[1]
