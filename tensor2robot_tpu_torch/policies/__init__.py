"""Policies: predictor -> action glue for robot control loops."""

from tensor2robot_tpu_torch.policies.policies import (
    CEMPolicy,
    JitCEMPolicy,
    LSTMCEMPolicy,
    OUExploreRegressionPolicy,
    PerEpisodeSwitchPolicy,
    Policy,
    RegressionPolicy,
    ScheduledExplorationRegressionPolicy,
    SequentialRegressionPolicy,
    default_pack_fn,
    split_action,
)
