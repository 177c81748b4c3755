"""Image encoding helpers.

Port of tensor2robot_tpu/utils/image.py. The JAX package encodes through
PIL; the port encodes through its own codecs (data/codec.py: JPEG through
libjpeg where the host has it, nvJPEG on the card's machine; PNG through
data/png.py), so it takes numpy arrays where the JAX package takes PIL
images, and its bytes may differ from PIL's; what a decoder reads back is
the same image, exactly for PNG and within the codec's round-trip error
for JPEG.
"""

from __future__ import annotations

import numpy as np

from tensor2robot_tpu_torch.data.codec import encode_image

#: PIL's JPEG quality when none is given (the JAX package's
#: numpy_to_image_string passes none).
PIL_DEFAULT_QUALITY = 75


def jpeg_string(image: np.ndarray, jpeg_quality: int = 90) -> bytes:
    """A JPEG bytestring of a uint8 HWC (or HW) array."""
    return encode_image(np.asarray(image, dtype=np.uint8), "jpeg", jpeg_quality)


def numpy_to_image_string(
    image_array: np.ndarray,
    image_format: str = "jpeg",
    dtype=np.uint8,
    quality: int = PIL_DEFAULT_QUALITY,
) -> bytes:
    """Encodes a numpy HWC array as an image bytestring ('jpeg' or
    'png')."""
    return encode_image(np.asarray(image_array, dtype=dtype), image_format, quality)
