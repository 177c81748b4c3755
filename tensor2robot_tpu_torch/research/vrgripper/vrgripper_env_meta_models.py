"""VRGripper meta-learning models: the MAML variant and Task-Embedded
Control.

Port of tensor2robot_tpu/research/vrgripper/vrgripper_env_meta_models.py.
TEC (arXiv:1810.03237) embeds the condition episodes into a task vector,
concatenates it (tiled over time) with per-step state features, and
decodes actions with a pluggable density head built as
`action_decoder_cls(input_size, output_size)` (decoders.py); the loss is
the decoder's NLL plus an optional end-token loss and an optional
contrastive loss between condition and inference embeddings. Modules are
named as the flax modules are (image_embedding, fc_reduce, film_params,
state_features, a_func, action_decoder).

The contrastive loss anchors on the batch's first task and takes the
others as negatives, so over data x fsdp shards a TEC model with
`embed_loss_weight > 0` is built with the trainer's mesh and gathers every
shard's embeddings before it (collectives.all_gather_data_shards).
"""

from __future__ import annotations

from typing import Tuple, Type, Union

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch.layers import tec as tec_lib
from tensor2robot_tpu_torch.layers.vision_layers import (
    FilmParams,
    ImageFeaturesToPoseNet,
    ImagesToFeaturesNet,
)
from tensor2robot_tpu_torch.meta_learning import meta_tfdata, preprocessors
from tensor2robot_tpu_torch.meta_learning.maml_model import MAMLModel
from tensor2robot_tpu_torch.models.abstract_model import (
    MODE_PREDICT,
    MODE_TRAIN,
    TorchT2RModel,
    generator_kwargs,
)
from tensor2robot_tpu_torch.models.base_models import sigmoid_binary_cross_entropy
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.research.vrgripper import decoders
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env_models import (
    FEATURE_POINTS,
    DefaultVRGripperPreprocessor,
    init_vrgripper_network,
)
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    copy_tensorspec,
)
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE

#: FiLM parameters for the 5-block, 32-channel state tower.
FILM_OUTPUT_SIZE = 2 * 5 * 32


class VRGripperEnvRegressionModelMAML(MAMLModel):
    """MAML-wrapped VRGripperRegressionModel."""

    def _select_inference_output(self, predictions: TensorSpecStruct):
        predictions["condition_output"] = predictions[
            "full_condition_output/inference_output"]
        predictions["inference_output"] = predictions[
            "full_inference_output/inference_output"]
        return predictions


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


class _TecNet(nn.Module):
    """The TEC forward over meta-shaped features: condition and inference
    subtrees with [B, num_episodes, T, ...] leaves."""

    def __init__(self, action_size: int, gripper_pose_size: int, num_waypoints: int,
                 episode_length: int, fc_embed_size: int, ignore_embedding: bool,
                 use_film: bool, predict_end_weight: float,
                 action_decoder_cls: Type[nn.Module]):
        super().__init__()
        self.episode_length = episode_length
        self.fc_embed_size = fc_embed_size
        self.ignore_embedding = ignore_embedding
        self.predict_end_weight = predict_end_weight
        # One embedder and reducer for condition and inference episodes.
        self.image_embedding = tec_lib.EmbedConditionImages()
        self.fc_reduce = tec_lib.ReduceTemporalEmbeddings(
            FEATURE_POINTS, fc_embed_size, episode_length,
            conv1d_kernel=min(10, episode_length))
        if use_film:
            self.film_params = FilmParams(fc_embed_size, FILM_OUTPUT_SIZE)
        self.state_features = ImagesToFeaturesNet(normalizer="layer_norm")
        width = FEATURE_POINTS + gripper_pose_size + (0 if ignore_embedding else fc_embed_size)
        self.a_func = ImageFeaturesToPoseNet(
            input_size=width, num_outputs=None,
            aux_output_dim=1 if predict_end_weight > 0 else 0)
        self.action_decoder = action_decoder_cls(100, num_waypoints * action_size)

    def _embed_episode(self, episode_features, train: bool) -> torch.Tensor:
        """[B, E, T, H, W, C] images -> l2-normalized [B, E, embed]."""
        image_embedding = meta_tfdata.multi_batch_apply(
            lambda im: self.image_embedding(im, train), 3, episode_features["features/image"])
        return _l2_normalize(meta_tfdata.multi_batch_apply(self.fc_reduce, 2,
                                                           image_embedding))

    def forward(self, features, mode, labels=None, generator=None):
        train = mode == MODE_TRAIN
        condition_embedding = self._embed_episode(features.condition, train)
        gripper_pose = features.inference.features["gripper_pose"]
        num_inference_episodes = gripper_pose.shape[1]
        # One task embedding (the mean over condition episodes), broadcast
        # over inference episodes and time.
        task_embedding = condition_embedding.mean(dim=1, keepdim=True)
        tile = (1, num_inference_episodes, self.episode_length, 1)

        film_params = None
        if hasattr(self, "film_params"):
            film_params = meta_tfdata.multi_batch_apply(self.film_params, 2, task_embedding)
            film_params = film_params[:, :, None, :].repeat(*tile)
        fc_embedding = task_embedding[..., :self.fc_embed_size][:, :, None, :].repeat(*tile)
        image = features.inference.features["image"]
        if film_params is not None:
            state_features, _ = meta_tfdata.multi_batch_apply(
                lambda im, fp: self.state_features(im, train, film_output_params=fp),
                3, image, film_params)
        else:
            state_features, _ = meta_tfdata.multi_batch_apply(
                lambda im: self.state_features(im, train), 3, image)
        pieces = [state_features, gripper_pose]
        if not self.ignore_embedding:
            pieces.append(fc_embedding)
        action_params, end_token = meta_tfdata.multi_batch_apply(
            self.a_func, 3, torch.cat(pieces, dim=-1))
        action_labels = None
        if labels is not None and "action" in labels.keys():
            action_labels = labels["action"]
        action, decoder_aux = self.action_decoder(action_params, labels=action_labels,
                                                  generator=generator)

        outputs = TensorSpecStruct()
        outputs["inference_output"] = action
        outputs["condition_embedding"] = condition_embedding
        for key, value in decoder_aux.items():
            outputs[f"decoder/{key}"] = value
        if self.predict_end_weight > 0:
            outputs["end_token_logits"] = end_token
            outputs["end_token"] = torch.sigmoid(end_token)
            outputs["inference_output"] = torch.cat(
                [outputs["inference_output"], outputs["end_token"]], dim=-1)
        if mode != MODE_PREDICT:
            outputs["inference_embedding"] = self._embed_episode(features.inference, train)
        return outputs


class VRGripperEnvTecModel(TorchT2RModel):
    """Task-Embedded Control Network."""

    def __init__(
        self,
        action_size: int = 7,
        gripper_pose_size: int = 14,
        num_waypoints: int = 1,
        episode_length: int = 40,
        embed_loss_weight: float = 0.0,
        fc_embed_size: int = 32,
        ignore_embedding: bool = False,
        action_decoder_cls: Type[nn.Module] = decoders.MDNDecoder,
        predict_end_weight: float = 0.0,
        use_film: bool = False,
        num_condition_samples_per_task: int = 1,
        image_size: Tuple[int, int] = (100, 100),
        mesh=None,
        **kwargs,
    ):
        kwargs.setdefault("preprocessor_cls", None)
        super().__init__(**kwargs)
        self._mesh = mesh
        self._action_size = action_size
        self._gripper_pose_size = gripper_pose_size
        self._num_waypoints = num_waypoints
        self._episode_length = episode_length
        self._embed_loss_weight = embed_loss_weight
        self._fc_embed_size = fc_embed_size
        self._ignore_embedding = ignore_embedding
        self._action_decoder_cls = action_decoder_cls
        self._predict_end_weight = predict_end_weight
        self._use_film = use_film
        self._num_condition_samples_per_task = num_condition_samples_per_task
        self._image_size = tuple(image_size)

    @property
    def loss_spans_the_batch(self) -> bool:
        return self._embed_loss_weight > 0

    def _episode_feature_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        spec = TensorSpecStruct(
            image=ExtendedTensorSpec(shape=self._image_size + (3,), dtype=np.float32,
                                     name="image0", data_format="jpeg"),
            gripper_pose=ExtendedTensorSpec(shape=(self._gripper_pose_size,),
                                            dtype=np.float32, name="world_pose_gripper"))
        return copy_tensorspec(spec, batch_size=self._episode_length)

    def _episode_label_specification(self, mode: str) -> TensorSpecStruct:
        del mode
        spec = TensorSpecStruct(action=ExtendedTensorSpec(
            shape=(self._action_size,), dtype=np.float32, name="action_world"))
        return copy_tensorspec(spec, batch_size=self._episode_length)

    @property
    def preprocessor(self):
        return preprocessors.FixedLenMetaExamplePreprocessor(
            base_preprocessor=DefaultVRGripperPreprocessor(_EpisodeSpecAdapter(self)),
            num_condition_samples_per_task=self._num_condition_samples_per_task)

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        return preprocessors.create_maml_feature_spec(
            self._episode_feature_specification(mode),
            self._episode_label_specification(mode))

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        return preprocessors.create_maml_label_spec(self._episode_label_specification(mode))

    def create_network(self) -> nn.Module:
        return _TecNet(
            action_size=self._action_size, gripper_pose_size=self._gripper_pose_size,
            num_waypoints=self._num_waypoints, episode_length=self._episode_length,
            fc_embed_size=self._fc_embed_size, ignore_embedding=self._ignore_embedding,
            use_film=self._use_film, predict_end_weight=self._predict_end_weight,
            action_decoder_cls=self._action_decoder_cls)

    def init_network(self, generator=None,
                     device: Union[str, torch.device] = DEFAULT_DEVICE) -> nn.Module:
        return init_vrgripper_network(self, generator, device)

    def inference_network_fn(self, network, features, mode, labels=None, generator=None):
        return dict(network(features, mode, labels=labels,
                            **generator_kwargs(network, generator))), {}

    def model_train_fn(self, features, labels, inference_outputs, mode):
        """BC NLL + optional end-token loss + optional contrastive
        embedding loss."""
        bc_loss = inference_outputs["decoder/nll"]
        metrics = {"loss/bc_nll": bc_loss}
        loss = bc_loss
        if self._predict_end_weight > 0:
            logits = inference_outputs["end_token_logits"]
            # The last two steps are end states.
            end_labels = torch.cat([torch.zeros_like(logits[:, :, :-2, :]),
                                    torch.ones_like(logits[:, :, -2:, :])], dim=2)
            end_loss = torch.mean(sigmoid_binary_cross_entropy(logits, end_labels))
            metrics["loss/end_token"] = end_loss
            loss = loss + self._predict_end_weight * end_loss
        if self._embed_loss_weight > 0:
            embeddings = [inference_outputs[key] for key in ("inference_embedding",
                                                              "condition_embedding")]
            if self._mesh is not None:
                embeddings = [collectives.all_gather_data_shards(e, self._mesh)
                              for e in embeddings]
            embed_loss = tec_lib.compute_embedding_contrastive_loss(*embeddings)
            metrics["loss/embed"] = embed_loss
            loss = loss + self._embed_loss_weight * embed_loss
        metrics["loss/total"] = loss
        return loss, metrics


class _EpisodeSpecAdapter:
    """A TEC model's per-episode specs as the model contract of its base
    preprocessor."""

    def __init__(self, model: VRGripperEnvTecModel):
        self._model = model

    def get_feature_specification(self, mode: str) -> TensorSpecStruct:
        return self._model._episode_feature_specification(mode)

    def get_label_specification(self, mode: str) -> TensorSpecStruct:
        return self._model._episode_label_specification(mode)
