"""Meta-learning: MAML over any T2RModel, its specs and preprocessors, the
MetaExample layout, meta policies and the per-task environment loop.

Port of tensor2robot_tpu/meta_learning/ with the same exports.
"""

from tensor2robot_tpu_torch.meta_learning import meta_example, meta_tfdata
from tensor2robot_tpu_torch.meta_learning.maml_inner_loop import (
    MAMLInnerLoopGradientDescent,
)
from tensor2robot_tpu_torch.meta_learning.maml_model import MAMLModel, MAMLNetwork
from tensor2robot_tpu_torch.meta_learning.meta_models import (
    MetalearningModel,
    MetaPreprocessor,
    create_meta_spec,
    select_mode,
)
from tensor2robot_tpu_torch.meta_learning.meta_policies import (
    FixedLengthSequentialRegressionPolicy,
    MAMLCEMPolicy,
    MAMLRegressionPolicy,
    MetaLearningPolicy,
    ScheduledExplorationMAMLRegressionPolicy,
)
from tensor2robot_tpu_torch.meta_learning.preprocessors import (
    FixedLenMetaExamplePreprocessor,
    MAMLPreprocessorV2,
    create_maml_feature_spec,
    create_maml_label_spec,
    create_metaexample_spec,
    stack_intra_task_episodes,
)
from tensor2robot_tpu_torch.meta_learning.run_meta_env import run_meta_env
