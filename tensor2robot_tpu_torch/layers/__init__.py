"""Layers of the port."""

from tensor2robot_tpu_torch.layers.spatial_softmax import spatial_softmax
from tensor2robot_tpu_torch.layers.transformer import (
    MultiHeadAttention,
    TransformerBlock,
    TransformerEncoder,
)
