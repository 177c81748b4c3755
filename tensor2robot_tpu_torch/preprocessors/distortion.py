"""Train-time image distortion helpers: thin aliases over
image_transformations for call-site parity (port of
tensor2robot_tpu/preprocessors/distortion.py)."""

from tensor2robot_tpu_torch.preprocessors.image_transformations import (
    crop_image_batch as crop_image,
    maybe_distort_image_batch,
    preprocess_image,
    resize_image_batch,
)

__all__ = [
    "crop_image",
    "maybe_distort_image_batch",
    "preprocess_image",
    "resize_image_batch",
]
