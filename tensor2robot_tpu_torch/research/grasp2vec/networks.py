"""Grasp2Vec embedding towers.

Port of tensor2robot_tpu/research/grasp2vec/networks.py: ResNet spatial
features of the last block layer -> relu -> mean-pooled vector. The
ResNet is `resnet`, as the flax submodule is named.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.resnet import ResNet


class Embedding(nn.Module):
    """Scene/goal embedding tower. Returns (mean embedding [B, C], spatial
    embedding map [B, h, w, C]). resnet_size defaults to the reference's
    ResNet50; smaller sizes keep tests cheap."""

    def __init__(self, resnet_size: int = 50):
        super().__init__()
        self.resnet = ResNet(num_classes=1, resnet_size=resnet_size)

    def forward(self, image: torch.Tensor,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        _, endpoints = self.resnet(image, train, return_intermediate_values=True)
        spatial = F.relu(endpoints["block_layer4"])
        return spatial.mean(dim=(1, 2)), spatial
