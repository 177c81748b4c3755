"""Meta-learning policies: fast adaptation from conditioning episodes.

Port of tensor2robot_tpu/meta_learning/meta_policies.py. A
MetaLearningPolicy carries the current task's conditioning episodes
(`adapt(episode_data)` / `reset_task()`); every action query feeds both
the conditioning data and the live observation, and the MAML model runs
its inner-loop adaptation inside the predictor's forward: the robot never
computes gradients itself. The conditioning data rides through the
policy's pack_fn as its `context` argument (a model's
`pack_features(state, prev_episode_data, timestep)`).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from tensor2robot_tpu_torch.policies.policies import (
    CEMPolicy,
    Policy,
    RegressionPolicy,
    ScheduledExplorationRegressionPolicy,
)


class MetaLearningPolicy(Policy):
    """Adds task-adaptation state to a policy."""

    _prev_episode_data: Optional[Any] = None

    def reset_task(self) -> None:
        self._prev_episode_data = None

    def adapt(self, episode_data) -> None:
        """Stores the conditioning episode(s) for the current task."""
        self._prev_episode_data = episode_data

    @property
    def prev_episode_data(self):
        return self._prev_episode_data


class MAMLCEMPolicy(MetaLearningPolicy, CEMPolicy):
    """CEM policy over a MAML critic: conditioning data joins the CEM
    objective features each query. Before the first adaptation the Q
    estimate is meaningless, so it is zeroed: actions are then draws from
    the proposal."""

    def _objective_fn(self, features):
        objective = super()._objective_fn(features)
        if self._prev_episode_data is not None:
            return objective
        return lambda samples: objective(samples) * 0.0

    def SelectAction(self, state, context=None, timestep: int = 0) -> np.ndarray:
        features = self._pack(state, self._prev_episode_data, timestep)
        return self.get_cem_action(features)


class _MAMLRegressionActionMixin(MetaLearningPolicy):
    """Shared MAML action selection: feed conditioning data, read the MAML
    model's required `inference_output`, drop the episode(/time) dims."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("action_key", "inference_output")
        super().__init__(*args, **kwargs)

    def SelectAction(self, state, context=None, timestep: int = 0) -> np.ndarray:
        features = self._pack(state, self._prev_episode_data, timestep)
        action = self._predict_action(features)
        # MAML outputs carry [inference_episode(, time), action] dims.
        if action.ndim == 3:
            return action[0, 0]
        if action.ndim == 2:
            return action[0]
        return action


class MAMLRegressionPolicy(_MAMLRegressionActionMixin, RegressionPolicy):
    """Feeds condition episode + live observation."""

    def sample_action(self, obs, explore_prob: float = 0.0):
        del explore_prob
        action = self.SelectAction(obs, None, 0)
        # Replay writers require is_demo when forming MetaExamples.
        return action, {"is_demo": False}


class FixedLengthSequentialRegressionPolicy(MetaLearningPolicy, RegressionPolicy):
    """Fixed-episode-length sequential policy: a_t is the t'th output of the
    model conditioned on the demo + the current episode so far."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("action_key", "inference_output")
        super().__init__(*args, **kwargs)
        self._current_episode_data = None
        self._t = 0

    def reset(self) -> None:
        self._current_episode_data = None
        self._t = 0

    def SelectAction(self, state, context=None, timestep: int = 0) -> np.ndarray:
        features = self._pack(
            state, (self._prev_episode_data, self._current_episode_data),
            self._t,
        )
        batch = {k: np.asarray(v)[None, ...] for k, v in features.items()}
        out = self._predictor.predict(batch)
        action = np.asarray(out[self._action_key])[0]
        self._current_episode_data = features
        # [inference_episode, T, action_dim] -> step t.
        action = action[0, self._t]
        self._t += 1
        return action


class ScheduledExplorationMAMLRegressionPolicy(
    _MAMLRegressionActionMixin, ScheduledExplorationRegressionPolicy
):
    """MAMLRegressionPolicy + linearly-scheduled gaussian action noise.
    Noise/clip logic lives in the scheduled base; this class only tags the
    MetaExample demo flag."""

    def sample_action(self, obs, explore_prob: float = 0.0):
        action, debug = super().sample_action(obs, explore_prob)
        debug["is_demo"] = False
        return action, debug
