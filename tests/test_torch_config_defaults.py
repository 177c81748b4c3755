"""The port's config defaults (config/defaults.py) and the two repairs that
let the JAX package's shipped gin configs run on the port.

  * The port registers exactly the names the JAX package's defaults
    register (64 after import; each side counted in a fresh interpreter).
    Each ported name builds the port's own object; each name whose module
    is not ported is a stub that raises naming its ROADMAP.md item.
  * D2: a config's `import tensor2robot_tpu.<m>` loads the port's
    `tensor2robot_tpu_torch.<m>`: parsing each shipped .gin file (and the
    port's copies) in a subprocess leaves neither jax nor
    tensor2robot_tpu in sys.modules; an import of JAX or of the JAX
    package itself raises ConfigError.
  * D3: run_train_reg.gin binds `PoseEnvRegressionModel.device_type =
    'tpu'`; the port's model takes it, the trainer wraps it in
    BFloat16ModelWrapper, and one bf16 train step matches the JAX
    package's TPUT2RModelWrapper step from the same weights on the same
    batch: the loss within 0.02 (the JAX bf16 gate the port's dtype-policy
    tests use), the gradient Adam took, and the update itself
    (test_run_train_reg_trains_under_the_bf16_wrapper_as_jax says how).
"""

import inspect
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from tensor2robot_tpu_torch import config as cfg
from tensor2robot_tpu_torch.models.tpu_model_wrapper import BFloat16ModelWrapper
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.train.infeed import to_device
from tensor2robot_tpu_torch.utils import jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(ROOT, "tensor2robot_tpu", "research", "pose_env", "configs")
PORT_CONFIGS = os.path.join(ROOT, "tensor2robot_tpu_torch", "research", "pose_env",
                            "configs")
CONFIG_FILES = ("common_imports.gin", "run_random_collect.gin", "run_train_reg.gin",
                "run_train_reg_maml.gin")
BF16_TOL = 0.02
ADAM_LR = 1e-3  # create_adam_optimizer's default in both packages
ADAM_B1 = 0.9
# bf16 gradients: the port's against JAX's, relative L2 per leaf and over
# all leaves. (JAX's own bf16 gradient is 0.071 from its float32 one over
# all leaves, 0.117 in its worst leaf; the two float32 gradients agree to
# 4e-6 of their leaf's largest.)
BF16_GRAD_TOL_LEAF = 0.3
BF16_GRAD_TOL_TREE = 0.1
# An element whose JAX bf16 gradient exceeds this share of its leaf's
# largest keeps its sign in the port (the elementwise bf16 difference is
# at most 0.32 of the leaf's largest here), so Adam's first step, the
# learning rate times the gradient's sign, must agree on it.
SIGN_POSED = 0.35
STUBS = {
    "Grasp2VecModel": "A8", "PoseEnvRegressionModelMAML": "A8",
    "VRGripperRegressionModel": "A8", "VRGripperDomainAdaptiveModel": "A8",
    "VRGripperEnvTecModel": "A8", "VRGripperEnvSimpleTrialModel": "A8",
    "VRGripperEnvRegressionModelMAML": "A8", "episode_to_transitions_reacher": "A8",
    "episode_to_transitions_metareacher": "A8", "make_fixed_length": "A8",
    "run_meta_env": "A8",
}
# The JAX package's registry after `import tensor2robot_tpu.config.defaults`.
JAX_NAMES = (
    "AsyncExportHookBuilder", "BestExporter", "CEMPolicy", "CheckpointPredictor",
    "ConfigLoggerHookBuilder", "DefaultConstantInputGenerator", "DefaultExportGenerator",
    "DefaultRandomInputGenerator", "DefaultRecordInputGenerator",
    "ExportedSavedModelPredictor", "FractionalRecordInputGenerator",
    "GeneratorInputGenerator", "GoldenValuesHookBuilder", "Grasp2VecModel",
    "Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom", "JitCEMPolicy",
    "LSTMCEMPolicy", "LatestExporter", "MockInputGenerator", "MockT2RModel",
    "MultiEvalRecordInputGenerator", "OUExploreRegressionPolicy", "PerEpisodeSwitchPolicy",
    "PoseEnvContinuousMCModel", "PoseEnvRandomPolicy", "PoseEnvRegressionModel",
    "PoseEnvRegressionModelMAML", "PoseToyEnv", "ProfilerHookBuilder", "RegressionPolicy",
    "SavedModelCodePredictor", "SavedModelSignaturePredictor",
    "ScheduledExplorationRegressionPolicy", "SequentialRegressionPolicy",
    "StepTimingHookBuilder", "TD3Hooks", "TFRecordReplayWriter", "TransformerBCModel",
    "VRGripperDomainAdaptiveModel", "VRGripperEnvRegressionModelMAML",
    "VRGripperEnvSimpleTrialModel", "VRGripperEnvTecModel", "VRGripperRegressionModel",
    "VariableLoggerHookBuilder", "WeightedRecordInputGenerator", "collect_eval_loop",
    "continuous_eval", "create_adam_optimizer", "create_constant_learning_rate",
    "create_default_exporters", "create_exponential_decay_learning_rate",
    "create_momentum_optimizer", "create_rms_prop_optimizer", "create_sgd_optimizer",
    "default_init_from_checkpoint_fn", "episode_to_transitions_metareacher",
    "episode_to_transitions_pose_toy", "episode_to_transitions_reacher",
    "make_fixed_length", "predict_from_model", "run_env", "run_meta_env",
    "run_tfagents_env", "train_eval_model",
)
PORTED = sorted(set(JAX_NAMES) - set(STUBS))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def clean_registry():
    """Bindings cleared around each test, and the registry's record of
    config imports restored: clear_config keeps it, and other tests of the
    worker compare operative configs."""
    import tensor2robot_tpu_torch.config.defaults  # noqa: F401
    from tensor2robot_tpu_torch.config import registry

    imports = list(registry._REGISTRY.imports)
    cfg.clear_config()
    yield
    cfg.clear_config()
    registry._REGISTRY.imports[:] = imports


def _python(script, block_jax=True):
    prelude = "import sys\n"
    if block_jax:
        prelude += ("for name in ('jax', 'jaxlib', 'flax', 'tensor2robot_tpu'):\n"
                    "    sys.modules[name] = None\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", prelude + script], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


_NAMES = ("from {package}.config import registry\n"
          "import {package}.config.defaults\n"
          "import json\nprint(json.dumps(sorted(registry._REGISTRY.configurables)))\n")


def test_registers_exactly_the_jax_defaults_names():
    port = json.loads(_python(_NAMES.format(package="tensor2robot_tpu_torch")))
    jax_names = json.loads(_python(_NAMES.format(package="tensor2robot_tpu"),
                                   block_jax=False))
    assert len(jax_names) == len(JAX_NAMES) == 64
    assert port == jax_names == sorted(JAX_NAMES)


def _original(registered):
    if inspect.isclass(registered):
        return registered.__mro__[1]
    return registered.__wrapped__


@pytest.mark.parametrize("name", PORTED)
def test_ported_names_build_the_ports_objects(name):
    original = _original(cfg.get_configurable(name))
    assert original.__module__.startswith("tensor2robot_tpu_torch."), original.__module__
    assert not original.__module__.startswith("tensor2robot_tpu_torch.config.defaults")
    if inspect.isclass(original):
        registered = cfg.get_configurable(name)
        assert issubclass(registered, original)


@pytest.mark.parametrize("name", sorted(STUBS))
def test_unported_names_raise_naming_their_item(name):
    stub = cfg.get_configurable(name)
    cfg.bind_parameter(f"{name}.anything", 1)  # bindings parse; the call raises
    with pytest.raises(NotImplementedError, match=rf"{name} is not ported yet "
                                                 rf"\(ROADMAP.md {STUBS[name]}\)"):
        stub()


SHIPPED = [os.path.join(JAX_CONFIGS, f) for f in CONFIG_FILES] + [
    os.path.join(PORT_CONFIGS, f) for f in CONFIG_FILES]


@pytest.fixture(scope="module")
def parsed_in_a_subprocess():
    """Each config parsed in turn in one fresh interpreter (nothing
    blocked): the JAX-side modules loaded after each, and the operative
    config's import line."""
    out = _python(
        "import json\n"
        "import tensor2robot_tpu_torch.config as cfg\n"
        "result = {}\n"
        f"for path in {SHIPPED!r}:\n"
        "    cfg.clear_config()\n"
        "    cfg.parse_config_file(path)\n"
        "    loaded = sorted(m for m in sys.modules if\n"
        "                    m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tensor2robot_tpu'))\n"
        "    result[path] = [loaded, cfg.operative_config_str().splitlines()[0]]\n"
        "print(json.dumps(result))\n", block_jax=False)
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: os.path.relpath(p, ROOT))
def test_shipped_configs_parse_without_jax(parsed_in_a_subprocess, path):
    loaded, first_import = parsed_in_a_subprocess[path]
    assert loaded == []
    assert first_import == "import tensor2robot_tpu_torch.config.defaults"


@pytest.mark.parametrize("statement", ["import jax", "import jax.numpy",
                                       "import tensor2robot_tpu", "import optax"])
def test_imports_of_jax_or_the_jax_package_raise(statement):
    with pytest.raises(cfg.ConfigError, match="never loads"):
        cfg.parse_config(statement)


@pytest.fixture(scope="module")
def jax_bf16_step():
    from tensor2robot_tpu.data import input_generators as jax_generators
    from tensor2robot_tpu.research.pose_env.pose_env_models import (
        PoseEnvRegressionModel as JaxPoseModel,
    )
    from tensor2robot_tpu.train.train_eval import CompiledModel, maybe_wrap_for_tpu

    model = maybe_wrap_for_tpu(JaxPoseModel(device_type="tpu"))
    generator = jax_generators.DefaultRandomInputGenerator(batch_size=4, seed=0)
    generator.set_specification_from_model(model, "train")
    batch = next(iter(generator.create_dataset("train")))
    compiled = CompiledModel(model, donate_state=False)
    state0 = compiled.init_state(jax.random.PRNGKey(0), batch)
    state1, metrics = compiled.train_step(state0, compiled.shard_batch(batch),
                                          jax.random.PRNGKey(1))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, jax.device_get(tree))  # noqa: E731
    adam = [s for s in jax.tree_util.tree_leaves(
        state1.opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1 and int(adam[0].count) == 1
    return dict(batch=batch, init=host(compiled.export_variables(state0)),
                final=host(compiled.export_variables(state1)),
                grads=host(jax.tree_util.tree_map(lambda m: m / (1 - ADAM_B1), adam[0].mu)),
                loss=float(metrics["loss"]), model=model)


def _bf16_update_failures(init, final, grads, jax_init, jax_final, jax_grads):
    """Where the port's bf16 step (its parameters before and after, the
    gradient Adam took) disagrees with JAX's: per leaf, the gradient past
    BF16_GRAD_TOL_LEAF relative L2 (BF16_GRAD_TOL_TREE over all leaves);
    on the elements whose sign is posed (SIGN_POSED), the update past
    BF16_TOL of JAX's largest update; anywhere, an update past Adam's
    one-step bound. Adam's first step is the learning rate times the
    gradient's sign, so an element whose gradient sits in bf16's noise may
    step either way: it is held to the bound alone."""
    failures, diff_sq, norm_sq = [], 0.0, 0.0
    for key, want_grad in jax_grads.items():
        diff = float((grads[key] - want_grad).norm())
        norm = float(want_grad.norm())
        diff_sq, norm_sq = diff_sq + diff ** 2, norm_sq + norm ** 2
        if not diff <= BF16_GRAD_TOL_LEAF * norm:
            failures.append(f"{key}: gradient {diff / norm:.3f} relative L2")
        moved, want_moved = final[key] - init[key], jax_final[key] - jax_init[key]
        for name, step in (("port", moved), ("jax", want_moved)):
            if not float(step.abs().max()) <= 1.002 * ADAM_LR:
                failures.append(f"{key}: {name} update past one Adam step")
        posed = want_grad.abs() > SIGN_POSED * float(want_grad.abs().max())
        if not posed.any():
            failures.append(f"{key}: no element's sign is posed")
            continue
        err = float((moved - want_moved)[posed].abs().max())
        if not err <= BF16_TOL * float(want_moved.abs().max()):
            failures.append(f"{key}: update off JAX's by {err:.3e} where posed")
    if not diff_sq ** 0.5 <= BF16_GRAD_TOL_TREE * norm_sq ** 0.5:
        failures.append(f"gradient {(diff_sq / norm_sq) ** 0.5:.3f} relative L2 overall")
    return failures


def test_run_train_reg_trains_under_the_bf16_wrapper_as_jax(jax_bf16_step):
    cfg.parse_config_file(os.path.join(JAX_CONFIGS, "run_train_reg.gin"))
    assert cfg.query_parameter("PoseEnvRegressionModel.device_type") == "tpu"
    model = cfg.get_configurable("PoseEnvRegressionModel")()
    assert model.device_type == "tpu" and model.is_device_tpu
    wrapped = train_eval.maybe_wrap_for_tpu(model)
    assert isinstance(wrapped, BFloat16ModelWrapper)
    assert train_eval.maybe_wrap_for_tpu(wrapped) is wrapped
    trainer = train_eval.Trainer(wrapped, device="cpu")
    state = trainer.init_state(
        params=jax_params.flax_variables_to_state_dict(jax_bf16_step["init"]))
    batch = jax_bf16_step["batch"]
    port_batch = {f"{group}/{key}": value for group in ("features", "labels")
                  for key, value in batch[group].items()}
    in_spec = wrapped.preprocessor.get_in_feature_specification("train")
    assert set(in_spec.keys()) == {k.split("/", 1)[1] for k in port_batch
                                   if k.startswith("features/")}
    init = {k: v.clone() for k, v in state.network.state_dict().items()}
    metrics = trainer.train_step(state, to_device(port_batch, "cpu"))
    assert abs(float(metrics["loss"]) - jax_bf16_step["loss"]) <= BF16_TOL
    params = dict(state.network.named_parameters())
    grads = {key: state.optimizer.state[p]["exp_avg"] / (1 - ADAM_B1)
             for key, p in params.items()}
    final = {key: p.detach() for key, p in params.items()}
    jax_init, jax_final = (jax_params.flax_variables_to_state_dict(jax_bf16_step[k])
                           for k in ("init", "final"))
    jax_grads = jax_params.flax_params_to_state_dict(jax_bf16_step["grads"])
    assert set(jax_grads) == set(params)
    reference = (jax_init, jax_final, jax_grads)
    assert _bf16_update_failures(init, final, grads, *reference) == []
    # Controls: no update, and the update with its sign flipped, fail.
    assert _bf16_update_failures(init, init, grads, *reference)
    flipped = {key: 2 * init[key] - final[key] for key in final}
    negated = {key: -g for key, g in grads.items()}
    assert _bf16_update_failures(init, flipped, negated, *reference)
    # The float32 forward of the same weights differs: the policy is on.
    f32 = train_eval.Trainer(model, device="cpu")
    f32_state = f32.init_state(
        params=jax_params.flax_variables_to_state_dict(jax_bf16_step["init"]))
    f32_loss = f32.train_step(f32_state, to_device(port_batch, "cpu"))["loss"]
    assert float(f32_loss) != float(metrics["loss"])
