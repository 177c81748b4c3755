"""Grasp2Vec embedding losses.

Port of tensor2robot_tpu/research/grasp2vec/losses.py. The masked losses
take where-masked means (0 for an empty mask), as the JAX package does.
Every loss computes in float32 whatever the embeddings' dtype. The
n-pairs cross-entropy has soft targets (same-label rows normalized), so
it is -sum(t * log_softmax) as optax.softmax_cross_entropy, not
F.cross_entropy over class indices.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch.layers.tec import triplet_semihard_loss
from tensor2robot_tpu_torch.models.base_models import sigmoid_binary_cross_entropy


def npairs_loss(labels: torch.Tensor, embeddings_anchor: torch.Tensor,
                embeddings_positive: torch.Tensor,
                reg_lambda: float = 0.002) -> torch.Tensor:
    """N-pairs loss: softmax cross-entropy over the anchor-positive
    similarity matrix with same-label targets, plus an L2 activation
    regularizer."""
    anchor, positive = embeddings_anchor.float(), embeddings_positive.float()
    reg_anchor = torch.sum(torch.square(anchor), 1).mean()
    reg_positive = torch.sum(torch.square(positive), 1).mean()
    l2loss = 0.25 * reg_lambda * (reg_anchor + reg_positive)
    similarity = anchor @ positive.T
    same_label = (labels[:, None] == labels[None, :]).to(similarity.dtype)
    targets = same_label / same_label.sum(dim=1, keepdim=True)
    xent = -(targets * F.log_softmax(similarity, dim=-1)).sum(dim=-1).mean()
    return xent + l2loss


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over mask == 1 entries; 0 when the mask is empty."""
    mask = mask.reshape(-1).to(values.dtype)
    total = mask.sum()
    return torch.where(total > 0, (values * mask).sum() / torch.clamp_min(total, 1.0),
                       0.0)


def _l2_normalize(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True),
                               1e-12)


def l2_arithmetic_loss(pregrasp_embedding, goal_embedding, postgrasp_embedding,
                       mask) -> torch.Tensor:
    """||pre - goal - post||^2 averaged over masked examples."""
    raw = (pregrasp_embedding.float() - goal_embedding.float()
           - postgrasp_embedding.float())
    return _masked_mean(torch.sum(torch.square(raw), dim=1), mask)


def cosine_arithmetic_loss(pregrasp_embedding, goal_embedding, postgrasp_embedding,
                           mask) -> torch.Tensor:
    """Cosine distance between normalized (pre - post) and goal."""
    pair_a = _l2_normalize(pregrasp_embedding.float() - postgrasp_embedding.float())
    pair_b = _l2_normalize(goal_embedding.float())
    return _masked_mean(1.0 - torch.sum(pair_a * pair_b, dim=1), mask)


def triplet_embedding_loss(
    pregrasp_embedding, goal_embedding, postgrasp_embedding,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Semi-hard triplet loss over normalized (pre - post, goal) pairs.
    Returns (loss, pairs, labels)."""
    pair_a = _l2_normalize(pregrasp_embedding.float() - postgrasp_embedding.float())
    pair_b = _l2_normalize(goal_embedding.float())
    n = pregrasp_embedding.shape[0]
    labels = torch.arange(n, dtype=torch.int32, device=pair_a.device).repeat(2)
    pairs = torch.cat([pair_a, pair_b], dim=0)
    return triplet_semihard_loss(labels, pairs, margin=3.0), pairs, labels


def npairs_embedding_loss(pregrasp_embedding, goal_embedding, postgrasp_embedding,
                          non_negativity_constraint: bool = False) -> torch.Tensor:
    """Bidirectional n-pairs loss over (pre - post, goal)."""
    pair_a = pregrasp_embedding.float() - postgrasp_embedding.float()
    if non_negativity_constraint:
        pair_a = F.relu(pair_a)
    pair_b = goal_embedding.float()
    labels = torch.arange(pregrasp_embedding.shape[0], device=pair_a.device)
    return npairs_loss(labels, pair_a, pair_b) + npairs_loss(labels, pair_b, pair_a)


def keypoint_accuracy(keypoints: torch.Tensor,
                      labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadrant accuracy of spatial-softmax keypoints (the Shapes
    dataset). Returns (accuracy, loss)."""
    keypoints = keypoints.float().reshape(-1, 2)
    quadrant_centers = torch.tensor(
        [[0.5, -0.5], [-0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]],
        dtype=torch.float32, device=keypoints.device)
    logits = keypoints @ quadrant_centers.T
    predictions = torch.argmax(logits, dim=1)
    correct = (labels == predictions).float()
    labels_onehot = F.one_hot(labels.long(), 4).float()
    loss = sigmoid_binary_cross_entropy(logits, labels_onehot).mean()
    return correct.mean(), loss


def send_to_zero_loss(tensor: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean L2 norm of masked rows."""
    return _masked_mean(torch.linalg.vector_norm(tensor.float(), dim=1), mask)
