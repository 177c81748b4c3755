"""MAML variant of the PoseEnv regression model.

Port of tensor2robot_tpu/research/pose_env/pose_env_maml_models.py
(`PoseEnvRegressionModelMAML`): selects the regression output for meta
policies and packs a live observation and the conditioning transitions
into the MetaExample feature layout (FixedLenMetaExamplePreprocessor's
columns). A missing conditioning episode becomes a dummy entry with reward
0, so the inner loop takes no gradient from it (the reward-weighted loss
gives it weight 0).
"""

from __future__ import annotations

import numpy as np

from tensor2robot_tpu_torch.meta_learning.maml_model import MAMLModel
from tensor2robot_tpu_torch.specs import TensorSpecStruct


class PoseEnvRegressionModelMAML(MAMLModel):
    """MAML regression for the duck task."""

    def _make_dummy_labels(self) -> TensorSpecStruct:
        label_spec = self._base_model.get_label_specification("train")
        return TensorSpecStruct(
            reward=np.zeros(tuple(label_spec["reward"].shape), np.float32),
            target_pose=np.zeros(tuple(label_spec["target_pose"].shape), np.float32),
        )

    def _select_inference_output(self, predictions: TensorSpecStruct):
        predictions["condition_output"] = predictions[
            "full_condition_output/inference_output"]
        predictions["inference_output"] = predictions[
            "full_inference_output/inference_output"]
        return predictions

    def pack_features(self, state, prev_episode_data, timestep) -> dict:
        """The observation and the first transition of the conditioning
        episode (or a reward-0 dummy) as MetaExample columns, batch 1."""
        del timestep
        meta_features = {"inference/features/state/0": state}

        def pack_condition_features(transition, idx, dummy_values=False):
            observation, action, reward = transition[0], transition[1], transition[2]
            meta_features[f"condition/features/state/{idx}"] = observation
            reward = 2.0 * np.asarray([reward], np.float32) - 1.0
            if dummy_values:
                # Weight 0: no inner-loop gradient from this entry.
                reward = np.array([0.0], np.float32)
            meta_features[f"condition/labels/target_pose/{idx}"] = np.asarray(
                action, np.float32)
            meta_features[f"condition/labels/reward/{idx}"] = reward

        if prev_episode_data:
            pack_condition_features(prev_episode_data[0][0], 0)
        else:
            dummy_labels = self._make_dummy_labels()
            dummy_transition = (state, dummy_labels["target_pose"],
                                float(dummy_labels["reward"][0]))
            pack_condition_features(dummy_transition, 0, dummy_values=True)
        return {key: np.expand_dims(np.asarray(value), 0)
                for key, value in meta_features.items()}
