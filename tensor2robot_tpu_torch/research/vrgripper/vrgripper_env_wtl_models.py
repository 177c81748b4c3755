"""Watch-Try-Learn trial and retrial models (arXiv:1906.03352).

Port of tensor2robot_tpu/research/vrgripper/vrgripper_env_wtl_models.py.
The trial model conditions on a demo episode (and, for retrial, on a first
trial episode and its success flag) through temporal embeddings of
full-state observations; the policy head maps [state, embeddings] to
actions over the fixed-length episode. Data arrives as MetaExamples.
Modules are named as the flax modules are (demo_embedding,
trial_embedding, a_func, mdn).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.layers import mdn as mdn_lib
from tensor2robot_tpu_torch.layers import tec as tec_lib
from tensor2robot_tpu_torch.layers.vision_layers import ImageFeaturesToPoseNet
from tensor2robot_tpu_torch.meta_learning import meta_tfdata, preprocessors
from tensor2robot_tpu_torch.models.abstract_model import TorchT2RModel
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import NoOpPreprocessor
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
    init_vrgripper_network,
)
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    copy_tensorspec,
)
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE


def pack_wtl_meta_features(state: np.ndarray, prev_episode_data, timestep: int,
                           episode_length: int, num_condition_samples_per_task: int,
                           action_size: int = 7) -> dict:
    """Packs a live observation and the conditioning episodes into the
    trial model's meta feature layout: flat numpy features with
    [1, num_episodes, T, ...] dims."""
    del timestep
    obs_size = np.asarray(state).shape[-1]

    def episode_to_array(episode_data):
        observations = [np.asarray(t[0]) for t in episode_data]
        while len(observations) < episode_length:
            observations.append(observations[-1])
        return np.stack(observations[:episode_length], axis=0)

    condition, success = [], []
    for episode_data in (prev_episode_data or [])[:num_condition_samples_per_task]:
        condition.append(episode_to_array(episode_data))
        episode_reward = float(np.sum([t[2] for t in episode_data]))
        success.append(np.full((episode_length, 1), float(episode_reward > 0), np.float32))
    while len(condition) < num_condition_samples_per_task:
        condition.append(np.zeros((episode_length, obs_size), np.float32))
        success.append(np.zeros((episode_length, 1), np.float32))
    inference = np.tile(np.asarray(state, np.float32)[None, :], (episode_length, 1))
    return {
        "condition/features/full_state_pose": np.stack(condition)[None, ...],
        "condition/labels/action": np.zeros(
            (1, num_condition_samples_per_task, episode_length, action_size), np.float32),
        "condition/labels/success": np.stack(success)[None, ...],
        "inference/features/full_state_pose": inference[None, None, ...],
    }


class _WtlTrialNet(nn.Module):
    """Trial/retrial policy head."""

    def __init__(self, obs_size: int, action_size: int, episode_length: int,
                 fc_embed_size: int, ignore_embedding: bool, num_mixture_components: int,
                 retrial: bool, embed_type: str):
        super().__init__()
        if embed_type not in ("temporal", "mean"):
            raise ValueError(f"Invalid embed_type: {embed_type}.")
        self.episode_length = episode_length
        self.ignore_embedding = ignore_embedding
        self.num_mixture_components = num_mixture_components
        self.action_size = action_size
        self.retrial = retrial
        self.embed_type = embed_type
        kernel = min(10, episode_length)
        if embed_type == "temporal":
            self.demo_embedding = tec_lib.ReduceTemporalEmbeddings(
                obs_size, fc_embed_size, episode_length, conv1d_kernel=kernel)
            embed_width = fc_embed_size
        else:
            embed_width = obs_size
        if retrial:
            trial_input = obs_size + 1 + embed_width
            if embed_type == "mean":
                self.trial_embedding = tec_lib.EmbedFullstate(trial_input, fc_embed_size)
            else:
                self.trial_embedding = tec_lib.ReduceTemporalEmbeddings(
                    trial_input, fc_embed_size, episode_length, conv1d_kernel=kernel)
            embed_width += fc_embed_size
        width = obs_size
        if not ignore_embedding:
            width += embed_width + (1 if retrial else 0)
        if num_mixture_components > 1:
            self.a_func = ImageFeaturesToPoseNet(input_size=width, num_outputs=None)
            self.mdn = mdn_lib.MDNParams(100, num_mixture_components, action_size)
        else:
            self.a_func = ImageFeaturesToPoseNet(input_size=width, num_outputs=action_size)

    def forward(self, features, mode, labels=None):
        del mode
        inf_pose = features.inference.features["full_state_pose"]
        con_pose = features.condition.features["full_state_pose"]
        # Success labels {0, 1} -> {-1, 1}.
        con_success = 2.0 * features.condition.labels["success"] - 1.0
        tile = (1, 1, self.episode_length, 1)
        if self.embed_type == "temporal":
            fc_embedding = meta_tfdata.multi_batch_apply(
                self.demo_embedding, 2, con_pose[:, 0:1])[:, :, None, :]
        else:
            fc_embedding = con_pose[:, 0:1, -1:, :]
        fc_embedding = fc_embedding.repeat(*tile)

        if self.retrial:
            # Condition episode 1 is the first trial, with its success.
            con_input = torch.cat([con_pose[:, 1:2], con_success[:, 1:2], fc_embedding],
                                  dim=-1)
            if self.embed_type == "mean":
                trial_embedding = meta_tfdata.multi_batch_apply(
                    self.trial_embedding, 3, con_input).mean(dim=-2)
            else:
                trial_embedding = meta_tfdata.multi_batch_apply(
                    self.trial_embedding, 2, con_input)
            fc_embedding = torch.cat(
                [fc_embedding, trial_embedding[:, :, None, :].repeat(*tile)], dim=-1)

        if self.ignore_embedding:
            fc_inputs = inf_pose
        else:
            pieces = [inf_pose, fc_embedding]
            if self.retrial:
                pieces.append(con_success[:, 1:2])
            fc_inputs = torch.cat(pieces, dim=-1)

        outputs = TensorSpecStruct()
        action_labels = None
        if labels is not None and "action" in labels.keys():
            action_labels = labels["action"]
        if self.num_mixture_components > 1:
            hidden, _ = meta_tfdata.multi_batch_apply(self.a_func, 3, fc_inputs)
            dist_params = meta_tfdata.multi_batch_apply(self.mdn, 3, hidden)
            gm = mdn_lib.get_mixture_distribution(dist_params, self.num_mixture_components,
                                                  self.action_size)
            action = gm.approximate_mode()
            outputs["dist_params"] = dist_params
            if action_labels is not None:
                outputs["nll"] = mdn_lib.mdn_loss(gm, action_labels)
        else:
            action, _ = meta_tfdata.multi_batch_apply(self.a_func, 3, fc_inputs)
            if action_labels is not None:
                outputs["nll"] = torch.mean(torch.square(action - action_labels))
        outputs["inference_output"] = action
        return outputs


class VRGripperEnvSimpleTrialModel(TorchT2RModel):
    """WTL trial model conditioning on the demo's full-state trajectory;
    retrial=True adds the first trial episode and its success flag."""

    def __init__(self, action_size: int = 7, episode_length: int = 40,
                 fc_embed_size: int = 32, ignore_embedding: bool = False,
                 num_mixture_components: int = 1, num_condition_samples_per_task: int = 1,
                 retrial: bool = False, embed_type: str = "temporal", obs_size: int = 32,
                 **kwargs):
        super().__init__(**kwargs)
        self._action_size = action_size
        self._episode_length = episode_length
        self._fc_embed_size = fc_embed_size
        self._ignore_embedding = ignore_embedding
        self._num_mixture_components = num_mixture_components
        self._num_condition_samples_per_task = num_condition_samples_per_task
        self._retrial = retrial
        self._embed_type = embed_type
        self._obs_size = obs_size
        if retrial and num_condition_samples_per_task != 2:
            raise ValueError("Retrial models need exactly 2 condition episodes "
                             "(demo + first trial).")

    @property
    def episode_length(self) -> int:
        return self._episode_length

    def _episode_feature_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        spec = TensorSpecStruct(full_state_pose=ExtendedTensorSpec(
            shape=(self._obs_size,), dtype=np.float32, name="full_state_pose"))
        return copy_tensorspec(spec, batch_size=self._episode_length)

    def _episode_label_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        spec = TensorSpecStruct(
            action=ExtendedTensorSpec(shape=(self._action_size,), dtype=np.float32,
                                      name="action_world"),
            success=ExtendedTensorSpec(shape=(1,), dtype=np.float32, name="success"))
        return copy_tensorspec(spec, batch_size=self._episode_length)

    @property
    def preprocessor(self):
        return preprocessors.FixedLenMetaExamplePreprocessor(
            base_preprocessor=NoOpPreprocessor(_WtlEpisodeSpecAdapter(self)),
            num_condition_samples_per_task=self._num_condition_samples_per_task)

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        return preprocessors.create_maml_feature_spec(
            self._episode_feature_specification(mode),
            self._episode_label_specification(mode))

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        return preprocessors.create_maml_label_spec(self._episode_label_specification(mode))

    def create_network(self) -> nn.Module:
        return _WtlTrialNet(
            obs_size=self._obs_size, action_size=self._action_size,
            episode_length=self._episode_length, fc_embed_size=self._fc_embed_size,
            ignore_embedding=self._ignore_embedding,
            num_mixture_components=self._num_mixture_components, retrial=self._retrial,
            embed_type=self._embed_type)

    def init_network(self, generator=None,
                     device: Union[str, torch.device] = DEFAULT_DEVICE) -> nn.Module:
        return init_vrgripper_network(self, generator, device)

    def inference_network_fn(self, network, features, mode, labels=None):
        return dict(network(features, mode, labels=labels)), {}

    def model_train_fn(self, features, labels, inference_outputs, mode):
        loss = inference_outputs["nll"]
        return loss, {"loss/bc": loss}

    def pack_features(self, state, prev_episode_data, timestep) -> dict:
        return pack_wtl_meta_features(state, prev_episode_data, timestep,
                                      self._episode_length,
                                      self._num_condition_samples_per_task,
                                      action_size=self._action_size)


class _WtlEpisodeSpecAdapter:
    def __init__(self, model: VRGripperEnvSimpleTrialModel):
        self._model = model

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        return self._model._episode_feature_specification(mode)

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        return self._model._episode_label_specification(mode)
