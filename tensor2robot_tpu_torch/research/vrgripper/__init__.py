"""VRGripper: behavioral cloning, TEC and Watch-Try-Learn models."""

from tensor2robot_tpu_torch.research.vrgripper import episode_to_transitions
from tensor2robot_tpu_torch.research.vrgripper.decoders import (
    MADE,
    DiscreteDecoder,
    MAFDecoder,
    MDNDecoder,
    MSEDecoder,
    get_discrete_action_loss,
    get_discrete_actions,
    get_discrete_bins,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_meta_models import (
    VRGripperEnvRegressionModelMAML,
    VRGripperEnvTecModel,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
    DefaultVRGripperPreprocessor,
    VRGripperDomainAdaptiveModel,
    VRGripperRegressionModel,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_wtl_models import (
    VRGripperEnvSimpleTrialModel,
    pack_wtl_meta_features,
)
