"""Layers of the port."""

from tensor2robot_tpu_torch.layers.mdn import (
    GaussianMixture,
    MDNDecoder,
    MDNParams,
    get_mixture_distribution,
    mdn_loss,
)
from tensor2robot_tpu_torch.layers.moe import MoEBlock
from tensor2robot_tpu_torch.layers.resnet import (
    LinearFilmGenerator,
    ResNet,
    get_block_sizes,
    get_resnet50_spatial,
)
from tensor2robot_tpu_torch.layers.snail import (
    AttentionBlock,
    CausalConv,
    DenseBlock,
    TCBlock,
    causally_masked_softmax,
)
from tensor2robot_tpu_torch.layers.spatial_softmax import spatial_softmax
from tensor2robot_tpu_torch.layers.tec import (
    EmbedConditionImages,
    EmbedFullstate,
    ReduceTemporalEmbeddings,
    compute_embedding_contrastive_loss,
    contrastive_loss,
    triplet_semihard_loss,
)
from tensor2robot_tpu_torch.layers.transformer import (
    MultiHeadAttention,
    TransformerBlock,
    TransformerEncoder,
)
from tensor2robot_tpu_torch.layers.vision_layers import (
    FilmParams,
    ImageFeaturesToPoseNet,
    ImagesToFeaturesHighResNet,
    ImagesToFeaturesNet,
    apply_film,
)
