"""Registers the framework surface as configurables.

Port of tensor2robot_tpu/config/defaults.py. Importing this module (or
`import tensor2robot_tpu_torch.config.defaults` in a .gin file, or the JAX
package's `import tensor2robot_tpu.config.defaults`, which the registry
maps here) registers under the JAX package's names everything its
defaults register: the trainer and continuous eval, input generators,
warm start, optimizers, mocks, hooks, exporters, predictors, policies,
the collect/eval loop and writers, episode runners and the research
models.

Names whose module is not ported yet register a stub that raises
NotImplementedError naming its ROADMAP.md item when called; a config that
binds them but never calls them parses and runs.
"""

from tensor2robot_tpu_torch.config.registry import external_configurable


def _unported(name: str, item: str):
    def stub(*args, **kwargs):
        del args, kwargs
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md {item})")

    stub.__name__ = stub.__qualname__ = name
    return external_configurable(stub, name)


# -- trainer ------------------------------------------------------------------
from tensor2robot_tpu_torch.train import train_eval as _train_eval

train_eval_model = external_configurable(
    _train_eval.train_eval_model, "train_eval_model"
)
predict_from_model = external_configurable(
    _train_eval.predict_from_model, "predict_from_model"
)
from tensor2robot_tpu_torch.train import continuous_eval as _continuous_eval

continuous_eval = external_configurable(
    _continuous_eval.continuous_eval, "continuous_eval"
)

# -- input generators ---------------------------------------------------------
from tensor2robot_tpu_torch.data import input_generators as _ig

for _cls_name in (
    "DefaultRecordInputGenerator",
    "FractionalRecordInputGenerator",
    "MultiEvalRecordInputGenerator",
    "WeightedRecordInputGenerator",
    "GeneratorInputGenerator",
    "DefaultRandomInputGenerator",
    "DefaultConstantInputGenerator",
):
    globals()[_cls_name] = external_configurable(
        getattr(_ig, _cls_name), _cls_name
    )

# -- warm start ---------------------------------------------------------------
from tensor2robot_tpu_torch.models import checkpoint_init as _ckpt_init

default_init_from_checkpoint_fn = external_configurable(
    _ckpt_init.default_init_from_checkpoint_fn, "default_init_from_checkpoint_fn"
)

# -- optimizers ---------------------------------------------------------------
from tensor2robot_tpu_torch.models import optimizers as _opt

for _fn_name in (
    "create_constant_learning_rate",
    "create_exponential_decay_learning_rate",
    "create_adam_optimizer",
    "create_sgd_optimizer",
    "create_momentum_optimizer",
    "create_rms_prop_optimizer",
):
    globals()[_fn_name] = external_configurable(getattr(_opt, _fn_name), _fn_name)

# -- mocks (used by smoke configs and tests) ---------------------------------
from tensor2robot_tpu_torch.utils import mocks as _mocks

MockT2RModel = external_configurable(_mocks.MockT2RModel, "MockT2RModel")
MockInputGenerator = external_configurable(
    _mocks.MockInputGenerator, "MockInputGenerator"
)

# -- hooks (register on import) -----------------------------------------------
from tensor2robot_tpu_torch import hooks as _hooks  # noqa: F401

# -- exporters and predictors -------------------------------------------------
from tensor2robot_tpu_torch.export import export_generators as _export_generators
from tensor2robot_tpu_torch.export import exporters as _exporters
from tensor2robot_tpu_torch.predictors import checkpoint_predictor as _ckpt_predictor
from tensor2robot_tpu_torch.predictors import (
    exported_savedmodel_predictor as _exported_predictor,
)
from tensor2robot_tpu_torch.predictors import saved_model_v2_predictor as _v2_predictor

for _module, _name in (
    (_exporters, "LatestExporter"),
    (_exporters, "BestExporter"),
    (_exporters, "create_default_exporters"),
    (_export_generators, "DefaultExportGenerator"),
    (_ckpt_predictor, "CheckpointPredictor"),
    (_exported_predictor, "ExportedSavedModelPredictor"),
    (_v2_predictor, "SavedModelCodePredictor"),
    (_v2_predictor, "SavedModelSignaturePredictor"),
):
    globals()[_name] = external_configurable(getattr(_module, _name), _name)

# -- policies / collect-eval / writers (register on import) -------------------
from tensor2robot_tpu_torch.policies import policies as _policies  # noqa: F401
from tensor2robot_tpu_torch.utils import writer as _writer  # noqa: F401
from tensor2robot_tpu_torch.utils import (  # noqa: F401
    continuous_collect_eval as _cce,
)

# -- episode runners ----------------------------------------------------------
from tensor2robot_tpu_torch.research import run_env as _run_env

run_env = external_configurable(_run_env.run_env, "run_env")
run_tfagents_env = external_configurable(
    _run_env.run_tfagents_env, "run_tfagents_env"
)
run_meta_env = _unported("run_meta_env", "A8")

# -- research model zoo -------------------------------------------------------
from tensor2robot_tpu_torch.research import pose_env as _pose_env  # noqa: F401
from tensor2robot_tpu_torch.research.qtopt import t2r_models as _qtopt_models

_critic = _qtopt_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom
globals()[_critic.__name__] = external_configurable(_critic, _critic.__name__)
for _name in (
    "Grasp2VecModel",
    "PoseEnvRegressionModelMAML",
    "VRGripperRegressionModel",
    "VRGripperDomainAdaptiveModel",
    "VRGripperEnvTecModel",
    "VRGripperEnvSimpleTrialModel",
    "VRGripperEnvRegressionModelMAML",
    "episode_to_transitions_reacher",
    "episode_to_transitions_metareacher",
    "make_fixed_length",
):
    globals()[_name] = _unported(_name, "A8")

# -- transformer model family -------------------------------------------------
from tensor2robot_tpu_torch.models import transformer_models as _transformer_models

TransformerBCModel = external_configurable(
    _transformer_models.TransformerBCModel, "TransformerBCModel"
)
