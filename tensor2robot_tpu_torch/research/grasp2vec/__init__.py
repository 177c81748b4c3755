"""Grasp2Vec: self-supervised grasp embeddings."""

from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
    Grasp2VecModel,
    Grasp2VecPreprocessor,
)
from tensor2robot_tpu_torch.research.grasp2vec.losses import (
    cosine_arithmetic_loss,
    keypoint_accuracy,
    l2_arithmetic_loss,
    npairs_embedding_loss,
    npairs_loss,
    send_to_zero_loss,
    triplet_embedding_loss,
)
from tensor2robot_tpu_torch.research.grasp2vec.networks import Embedding
