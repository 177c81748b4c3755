"""PoseToyEnv: environment, transition converter and models."""

from tensor2robot_tpu_torch.config import external_configurable
from tensor2robot_tpu_torch.research.pose_env.episode_to_transitions import (
    episode_to_transitions_pose_toy,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    PoseEnvRandomPolicy,
    PoseToyEnv,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models import (
    PoseEnvRegressionModelMAML,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
    DefaultPoseEnvContinuousPreprocessor,
    DefaultPoseEnvRegressionPreprocessor,
    PoseEnvContinuousMCModel,
    PoseEnvRegressionModel,
)

for _cls in (PoseEnvContinuousMCModel, PoseEnvRegressionModel,
             PoseEnvRegressionModelMAML):
    external_configurable(_cls, _cls.__name__)
