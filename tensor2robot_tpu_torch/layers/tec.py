"""Task-embedded control (TEC) embedding layers and contrastive losses.

Port of tensor2robot_tpu/layers/tec.py. Modules are named as the flax
modules are (fc0, ln0, fc_out, tower, conv1d_0, conv_ln_0, conv1x1_0,
...), so utils/jax_params.py maps a flax variables tree onto them. The
layers take their input widths (and ReduceTemporalEmbeddings its
sequence length, which sizes the flattened temporal conv output) at
construction, where flax infers them at the first call.

The losses compute in float32 whatever the embeddings' dtype: the
semi-hard triplet mining's pdist - 2 e e^T + pdist^T cancels badly, and a
rounding change moves which negative counts as semi-hard.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.vision_layers import ImagesToFeaturesNet
from tensor2robot_tpu_torch.models.base_models import sigmoid_binary_cross_entropy
from tensor2robot_tpu_torch.research.dql_grasping_lib.tf_modules import (
    FlaxLayerNorm,
    conv2d_nhwc,
)


class EmbedFullstate(nn.Module):
    """MLP embedding of non-image state observations."""

    def __init__(self, input_size: int, embed_size: int,
                 fc_layers: Sequence[int] = (100,)):
        super().__init__()
        self.num_layers = len(fc_layers)
        width = input_size
        for i, hidden in enumerate(fc_layers):
            self.add_module(f"fc{i}", nn.Linear(width, hidden))
            self.add_module(f"ln{i}", FlaxLayerNorm(hidden))
            width = hidden
        self.fc_out = nn.Linear(width, embed_size)

    def forward(self, fullstate: torch.Tensor) -> torch.Tensor:
        net = fullstate
        for i in range(self.num_layers):
            net = F.relu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(net)))
        return self.fc_out(net)


class EmbedConditionImages(nn.Module):
    """Embeds a batch of NHWC RGB images through the conv tower, then
    optionally fc layers (feature points) or 1x1 convs (feature maps)."""

    def __init__(self, fc_layers: Optional[Sequence[int]] = None,
                 use_spatial_softmax: bool = True):
        super().__init__()
        self.tower = ImagesToFeaturesNet(use_spatial_softmax=use_spatial_softmax)
        self.use_spatial_softmax = use_spatial_softmax
        self.fc_layers = None if fc_layers is None else list(fc_layers)
        if self.fc_layers is None:
            return
        maps = self.tower.final_conv_1x1.out_channels
        width = 2 * maps if use_spatial_softmax else maps
        hidden, final = self.fc_layers[:-1], self.fc_layers[-1]
        for i, size in enumerate(hidden):
            if use_spatial_softmax:
                self.add_module(f"fc{i}", nn.Linear(width, size))
            else:
                self.add_module(f"conv1x1_{i}", nn.Conv2d(width, size, 1))
            self.add_module(f"ln{i}", FlaxLayerNorm(size))
            width = size
        if use_spatial_softmax:
            self.fc_out = nn.Linear(width, final)
        else:
            self.conv1x1_out = nn.Conv2d(width, final, 1)

    def forward(self, condition_image: torch.Tensor, train: bool = False):
        if condition_image.ndim != 4:
            raise ValueError(
                f"Image has unexpected shape {tuple(condition_image.shape)}.")
        embedding, _ = self.tower(condition_image, train)
        if self.fc_layers is None:
            return embedding
        for i in range(len(self.fc_layers) - 1):
            if self.use_spatial_softmax:
                embedding = getattr(self, f"fc{i}")(embedding)
            else:
                embedding = conv2d_nhwc(getattr(self, f"conv1x1_{i}"), embedding)
            embedding = F.relu(getattr(self, f"ln{i}")(embedding))
        if self.use_spatial_softmax:
            return self.fc_out(embedding)
        return conv2d_nhwc(self.conv1x1_out, embedding)


class ReduceTemporalEmbeddings(nn.Module):
    """Reduces [N, T, F] per-frame embeddings (or [N, T, h, w, F] maps,
    averaged over space) to one [N, output_size] vector through temporal
    convs (VALID, no bias, kernel `conv1d_kernel`), then fc layers."""

    def __init__(
        self,
        input_size: int,
        output_size: int,
        sequence_length: int,
        conv1d_layers: Optional[Sequence[int]] = (64,),
        fc_hidden_layers: Sequence[int] = (100,),
        combine_mode: str = "temporal_conv",
        conv1d_kernel: int = 10,
    ):
        super().__init__()
        self.combine_mode = combine_mode
        self.conv1d_kernel = conv1d_kernel
        self.num_convs = 0
        self.num_fc = len(fc_hidden_layers)
        width, length = input_size, sequence_length
        if "temporal_conv" in combine_mode:
            for i, filters in enumerate(conv1d_layers or ()):
                # The kernel is a static config choice, not clamped to the
                # sequence length: parameter shapes must not depend on T.
                if length < conv1d_kernel:
                    raise ValueError(
                        f"Temporal length {length} is shorter than conv1d_kernel="
                        f"{conv1d_kernel}; configure a smaller conv1d_kernel.")
                self.add_module(f"conv1d_{i}",
                                nn.Conv1d(width, filters, conv1d_kernel, bias=False))
                self.add_module(f"conv_ln_{i}", FlaxLayerNorm(filters))
                width, length = filters, length - conv1d_kernel + 1
                self.num_convs += 1
            if combine_mode != "temporal_conv_avg_after":
                width *= length
        for i, hidden in enumerate(fc_hidden_layers):
            self.add_module(f"fc{i}", nn.Linear(width, hidden))
            self.add_module(f"ln{i}", FlaxLayerNorm(hidden))
            width = hidden
        self.fc_out = nn.Linear(width, output_size)

    def forward(self, temporal_embedding: torch.Tensor) -> torch.Tensor:
        if temporal_embedding.ndim == 5:
            temporal_embedding = temporal_embedding.mean(dim=(2, 3))
        if temporal_embedding.ndim != 3:
            raise ValueError("Temporal embedding has unexpected shape "
                             f"{tuple(temporal_embedding.shape)}.")
        embedding = temporal_embedding
        if "temporal_conv" not in self.combine_mode:
            embedding = embedding.mean(dim=1)
        else:
            for i in range(self.num_convs):
                if embedding.shape[1] < self.conv1d_kernel:
                    raise ValueError(
                        f"Temporal length {embedding.shape[1]} is shorter than "
                        f"conv1d_kernel={self.conv1d_kernel}; configure a smaller "
                        "conv1d_kernel.")
                embedding = getattr(self, f"conv1d_{i}")(
                    embedding.transpose(1, 2)).transpose(1, 2)
                embedding = F.relu(getattr(self, f"conv_ln_{i}")(embedding))
            if self.combine_mode == "temporal_conv_avg_after":
                embedding = embedding.mean(dim=1)
            else:
                embedding = embedding.reshape(embedding.shape[0], -1)
        for i in range(self.num_fc):
            embedding = F.relu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(embedding)))
        return self.fc_out(embedding)


def contrastive_loss(labels: torch.Tensor, anchor: torch.Tensor,
                     embeddings: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """Hadsell et al. contrastive loss between one anchor and N embeddings:
    positives pull to distance 0, negatives push beyond `margin`."""
    anchor, embeddings = anchor.float(), embeddings.float()
    d = torch.sqrt(torch.clamp_min(
        torch.sum(torch.square(anchor - embeddings), dim=-1), 1e-12))
    labels_f = labels.to(d.dtype)
    loss = labels_f * torch.square(d) + (1.0 - labels_f) * torch.square(
        torch.clamp_min(margin - d, 0.0))
    return loss.mean()


def triplet_semihard_loss(labels: torch.Tensor, embeddings: torch.Tensor,
                          margin: float = 1.0) -> torch.Tensor:
    """Semi-hard triplet mining loss: for each anchor-positive pair, the
    nearest negative further than the positive when one exists, else the
    furthest negative."""
    embeddings = embeddings.float()
    pdist = torch.sum(torch.square(embeddings), dim=1, keepdim=True)
    dist_sq = pdist - 2.0 * embeddings @ embeddings.T + pdist.T
    dist = torch.sqrt(torch.clamp_min(dist_sq, 1e-12))
    n = embeddings.shape[0]
    adjacency = labels[:, None] == labels[None, :]
    adjacency_not = ~adjacency
    eye = torch.eye(n, dtype=torch.bool, device=embeddings.device)
    pos_mask = adjacency & ~eye

    d_an = dist[:, None, :]  # [anchor, 1, neg]
    d_ap = dist[:, :, None]  # [anchor, pos, 1]
    semihard_mask = adjacency_not[:, None, :] & (d_an > d_ap)
    inf = torch.tensor(float("inf"), dtype=dist.dtype, device=dist.device)
    min_semihard = torch.where(semihard_mask, d_an, inf).amin(dim=2)
    max_neg = torch.where(adjacency_not, dist, -inf).amax(dim=1)
    has_semihard = semihard_mask.any(dim=2)
    neg_dist = torch.where(has_semihard, min_semihard, max_neg[:, None])
    loss_mat = torch.clamp_min(dist - neg_dist + margin, 0.0)
    num_pos = torch.clamp_min(pos_mask.sum(), 1)
    return torch.where(pos_mask, loss_mat, 0.0).sum() / num_pos


def compute_embedding_contrastive_loss(
    inf_embedding: torch.Tensor,
    con_embedding: torch.Tensor,
    positives: Optional[torch.Tensor] = None,
    contrastive_loss_mode: str = "both_directions",
) -> torch.Tensor:
    """Contrastive loss between inference and condition embeddings
    ([num_tasks, num_episodes, K], L2-normalized); `positives` is an
    optional [num_tasks] bool mask w.r.t. task 0. Modes: default,
    both_directions, reverse_direction, cross_entropy, triplet."""
    if inf_embedding.ndim != 3:
        raise ValueError(f"Unexpected inf_embedding shape: {tuple(inf_embedding.shape)}.")
    if con_embedding.ndim != 3:
        raise ValueError(f"Unexpected con_embedding shape: {tuple(con_embedding.shape)}.")
    avg_inf = inf_embedding.float().mean(dim=1)
    avg_con = con_embedding.float().mean(dim=1)
    anchor = avg_inf[0:1]
    num_tasks = avg_con.shape[0]
    if positives is not None:
        labels = positives
    else:
        labels = torch.arange(num_tasks, device=avg_con.device) == 0

    if contrastive_loss_mode == "default":
        return contrastive_loss(labels, anchor, avg_con)
    if contrastive_loss_mode == "both_directions":
        return (contrastive_loss(labels, anchor, avg_con)
                + contrastive_loss(labels, avg_con[0:1], avg_inf))
    if contrastive_loss_mode == "reverse_direction":
        return contrastive_loss(labels, avg_con[0:1], avg_inf)
    if contrastive_loss_mode == "cross_entropy":
        temperature = 2.0
        sim1 = torch.sum(anchor * avg_con, dim=1)
        sim2 = torch.sum(avg_con[0:1] * avg_inf, dim=1)
        return (sigmoid_binary_cross_entropy(temperature * sim1, labels).mean()
                + sigmoid_binary_cross_entropy(temperature * sim2, labels).mean())
    if contrastive_loss_mode == "triplet":
        if positives is None:
            positives = torch.arange(num_tasks, dtype=torch.int32, device=avg_con.device)
        tiled = positives.repeat(2)
        embeds = torch.cat([avg_inf, avg_con], dim=0)
        return triplet_semihard_loss(tiled, embeds, margin=3.0)
    raise ValueError("Did not understand contrastive_loss_mode")
