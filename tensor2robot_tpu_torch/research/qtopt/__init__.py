"""QT-Opt: the Grasping44 grasping critic."""

from tensor2robot_tpu_torch.research.qtopt import networks, optimizer_builder, pcgrad
from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
    DefaultGrasping44ImagePreprocessor,
    Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom,
    GraspingModelWrapper,
)
