"""Image transformations as torch functions over [B, H, W, C] batches.

Crops and photometric distortions of the robotic-vision preprocessors.
Port of tensor2robot_tpu/preprocessors/image_transformations.py, with the
same formulas (its own RGB <-> HSV conversion, the cyclic op orders of
`random_order`), run on the images' device.

Every random op is split in two: a draw (`draw_*`) takes its numbers from
an explicit `torch.Generator` on the images' device, and the apply takes
the drawn numbers. The one-call form (`random_crop_image_batch`,
`apply_photometric_image_distortions`, ...) draws and applies; a test
passes the JAX package's draws to the apply instead, since threefry keys
cannot be reproduced with a torch generator.

Images are float32 in [0, 1] unless stated otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


def _check_crop(image_shape, target_shape) -> None:
    h, w = int(image_shape[-3]), int(image_shape[-2])
    th, tw = int(target_shape[0]), int(target_shape[1])
    if th > h or tw > w:
        raise ValueError(f"Crop {tuple(target_shape)} larger than image {(h, w)}.")


def _uniform(generator, size, low, high, device) -> torch.Tensor:
    """U[low, high) as jax.random.uniform(minval=low, maxval=high)."""
    u = torch.rand(size, generator=generator, device=device)
    return u * (high - low) + low


def _per_image(value: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """A [B] vector (or a scalar) broadcast over [B, H, W, C]."""
    value = torch.as_tensor(value, dtype=images.dtype, device=images.device)
    return value.reshape((-1,) + (1,) * (images.ndim - 1)) if value.ndim else value


def uint8_to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]: x / 255 as an IEEE division on every
    device. The divisor is a tensor on the images' device: CUDA divides by
    a Python scalar as a multiply by its reciprocal, which differs from
    the division (the CPU's and the JAX package's) in the last bit, and a
    max pool downstream turns such bits into a different gradient. The
    divisor is filled on the device, not copied from the host, so the
    call does not synchronize the stream."""
    return images.float() / torch.full((), 255.0, device=images.device)


# -- crops ---------------------------------------------------------------------


def draw_random_crop_offsets(
    generator: Optional[torch.Generator], batch: int, image_hw: Sequence[int],
    target_shape: Sequence[int], device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (y, x) offset per image, each uniform over the valid range
    (int64 [B] each), y drawn first."""
    th, tw = int(target_shape[0]), int(target_shape[1])
    h, w = int(image_hw[0]), int(image_hw[1])
    ys = torch.randint(0, h - th + 1, (batch,), generator=generator, device=device)
    xs = torch.randint(0, w - tw + 1, (batch,), generator=generator, device=device)
    return ys, xs


def crop_image_batch_at(
    images: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
    target_shape: Sequence[int],
) -> torch.Tensor:
    """Crops image i of [B, H, W, C] at (ys[i], xs[i]) to [B, th, tw, C]
    (the apply of a random crop; one gather, no host sync)."""
    _check_crop(images.shape, target_shape)
    th, tw = int(target_shape[0]), int(target_shape[1])
    device = images.device
    ys, xs = ys.to(device), xs.to(device)
    rows = ys[:, None] + torch.arange(th, device=device)
    cols = xs[:, None] + torch.arange(tw, device=device)
    batch = torch.arange(images.shape[0], device=device)
    return images[batch[:, None, None], rows[:, :, None], cols[:, None, :]]


def random_crop_image_batch(
    generator: Optional[torch.Generator], images: torch.Tensor,
    target_shape: Sequence[int],
) -> torch.Tensor:
    """Randomly crops a [B, H, W, C] batch to [B, th, tw, C], one offset
    per image."""
    _check_crop(images.shape, target_shape)
    ys, xs = draw_random_crop_offsets(
        generator, images.shape[0], images.shape[1:3], target_shape,
        images.device,
    )
    return crop_image_batch_at(images, ys, xs, target_shape)


def center_crop_image_batch(
    images: torch.Tensor, target_shape: Sequence[int]
) -> torch.Tensor:
    """Deterministic center crop (offsets floor((size - target) / 2))."""
    _check_crop(images.shape, target_shape)
    th, tw = int(target_shape[0]), int(target_shape[1])
    h, w = images.shape[-3], images.shape[-2]
    y, x = (h - th) // 2, (w - tw) // 2
    return images[..., y:y + th, x:x + tw, :]


def custom_crop_image_batch(
    images: torch.Tensor, y: int, x: int, target_shape: Sequence[int]
) -> torch.Tensor:
    """Fixed-offset crop."""
    _check_crop(images.shape, target_shape)
    th, tw = int(target_shape[0]), int(target_shape[1])
    h, w = int(images.shape[-3]), int(images.shape[-2])
    if y < 0 or x < 0 or y + th > h or x + tw > w:
        raise ValueError(
            f"Crop offset ({y}, {x}) + size ({th}, {tw}) exceeds image "
            f"bounds ({h}, {w})."
        )
    return images[..., y:y + th, x:x + tw, :]


# -- photometric distortions -----------------------------------------------------


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), 0.0)
    safe_delta = torch.clamp_min(delta, 1e-12)
    rc = (maxc - r) / safe_delta
    gc = (maxc - g) / safe_delta
    bc = (maxc - b) / safe_delta
    h = torch.where(
        maxc == r, bc - gc,
        torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc),
    )
    h = torch.where(delta == 0.0, 0.0, torch.remainder(h / 6.0, 1.0))
    return torch.stack([h, s, v], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    # The JAX package's sector-free form: c(n) = v - v*s*clip(min(k, 4-k),
    # 0, 1) with k = (n + 6h) mod 6, elementwise (no per-pixel table).
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]

    def channel(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([channel(5.0), channel(3.0), channel(1.0)], dim=-1)


def adjust_brightness(image: torch.Tensor, delta) -> torch.Tensor:
    """`delta` a scalar or one value per image of a [B, H, W, C] batch."""
    return image + _per_image(delta, image)


def adjust_contrast(image: torch.Tensor, factor) -> torch.Tensor:
    mean = torch.mean(image, dim=(-3, -2), keepdim=True)
    return (image - mean) * _per_image(factor, image) + mean


def adjust_saturation(image: torch.Tensor, factor) -> torch.Tensor:
    gray = torch.mean(image, dim=-1, keepdim=True)
    return gray + (image - gray) * _per_image(factor, image)


def adjust_hue(image: torch.Tensor, delta) -> torch.Tensor:
    hsv = _rgb_to_hsv(torch.clamp(image, 0.0, 1.0))
    delta = _per_image(delta, image)
    if delta.ndim:
        delta = delta[..., 0]
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


# The cyclic rotations of the op order (brightness, saturation, hue,
# contrast) that random_order picks from: 4 orders, not 4! = 24.
CYCLIC_ORDERS = tuple(tuple((i + s) % 4 for i in range(4)) for s in range(4))


@dataclasses.dataclass
class PhotometricDraws:
    """The numbers one photometric distortion of a batch uses, one per
    image: brightness delta, saturation factor, hue delta, contrast factor;
    `order` the index into CYCLIC_ORDERS (random_order only) and `noise` a
    standard normal per pixel (noise_stddev > 0 only)."""

    brightness: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor
    contrast: torch.Tensor
    order: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None


def draw_photometric_distortions(
    generator: Optional[torch.Generator],
    images_shape: Sequence[int],
    device=None,
    max_delta_brightness: float = 32.0 / 255.0,
    lower_saturation: float = 0.5,
    upper_saturation: float = 1.5,
    max_delta_hue: float = 0.2,
    lower_contrast: float = 0.5,
    upper_contrast: float = 1.5,
    noise_stddev: float = 0.0,
    random_order: bool = False,
) -> PhotometricDraws:
    """Draws a batch's distortion parameters, in the order of the fields."""
    batch = int(images_shape[0])
    draws = PhotometricDraws(
        brightness=_uniform(generator, batch, -max_delta_brightness,
                            max_delta_brightness, device),
        saturation=_uniform(generator, batch, lower_saturation,
                            upper_saturation, device),
        hue=_uniform(generator, batch, -max_delta_hue, max_delta_hue, device),
        contrast=_uniform(generator, batch, lower_contrast, upper_contrast,
                          device),
    )
    if random_order:
        draws.order = torch.randint(0, len(CYCLIC_ORDERS), (batch,),
                                    generator=generator, device=device)
    if noise_stddev > 0.0:
        draws.noise = torch.randn(tuple(images_shape), generator=generator,
                                  device=device)
    return draws


def _distort(images: torch.Tensor, draws: PhotometricDraws, order) -> torch.Tensor:
    params = (draws.brightness, draws.saturation, draws.hue, draws.contrast)
    ops = (adjust_brightness, adjust_saturation, adjust_hue, adjust_contrast)
    for index in order:
        images = ops[index](images, params[index])
    return torch.clamp(images, 0.0, 1.0)


def _select(draws: PhotometricDraws, rows: torch.Tensor) -> PhotometricDraws:
    return PhotometricDraws(
        *(getattr(draws, f)[rows] for f in ("brightness", "saturation", "hue",
                                             "contrast"))
    )


def apply_photometric_image_distortions(
    generator: Optional[torch.Generator],
    images: torch.Tensor,
    max_delta_brightness: float = 32.0 / 255.0,
    lower_saturation: float = 0.5,
    upper_saturation: float = 1.5,
    max_delta_hue: float = 0.2,
    lower_contrast: float = 0.5,
    upper_contrast: float = 1.5,
    noise_stddev: float = 0.0,
    random_order: bool = False,
    draws: Optional[PhotometricDraws] = None,
) -> torch.Tensor:
    """Random brightness, saturation, hue and contrast, then optional pixel
    noise, independently per image of a [B, H, W, C] batch, clipped to
    [0, 1] after the ops and again after the noise. `draws` (e.g. the JAX
    package's) replaces the draw from `generator`."""
    if draws is None:
        draws = draw_photometric_distortions(
            generator, images.shape, images.device,
            max_delta_brightness=max_delta_brightness,
            lower_saturation=lower_saturation,
            upper_saturation=upper_saturation, max_delta_hue=max_delta_hue,
            lower_contrast=lower_contrast, upper_contrast=upper_contrast,
            noise_stddev=noise_stddev, random_order=random_order,
        )
    if random_order:
        # Each order applied to the images that drew it.
        out = torch.empty_like(images)
        for index, order in enumerate(CYCLIC_ORDERS):
            rows = torch.nonzero(draws.order == index).flatten()
            out[rows] = _distort(images[rows], _select(draws, rows), order)
        images = out
    else:
        images = _distort(images, draws, CYCLIC_ORDERS[0])
    if noise_stddev > 0.0:
        images = torch.clamp(images + noise_stddev * draws.noise, 0.0, 1.0)
    return images


def apply_depth_image_distortions(
    generator: Optional[torch.Generator],
    depth_images: torch.Tensor,
    noise_stddev: float = 0.02,
    clip_min: float = 0.0,
    clip_max: float = 1.0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-pixel gaussian noise on depth maps; `noise` (a standard normal
    of the maps' shape) replaces the draw from `generator`."""
    if noise is None:
        noise = torch.randn(depth_images.shape, generator=generator,
                            device=depth_images.device)
    return torch.clamp(depth_images + noise_stddev * noise, clip_min, clip_max)


# -- composite helpers (re-exported by preprocessors/distortion.py) ----------------


def maybe_distort_image_batch(
    generator: Optional[torch.Generator], images: torch.Tensor, mode: str,
    **distortion_kwargs,
) -> torch.Tensor:
    """Distorts only in train mode, and only with a generator."""
    if mode != "train" or generator is None:
        return images
    return apply_photometric_image_distortions(
        generator, images, **distortion_kwargs
    )


def crop_image_batch(
    generator: Optional[torch.Generator], images: torch.Tensor,
    target_shape: Sequence[int], mode: str,
) -> torch.Tensor:
    """Random crop when training with a generator, center crop otherwise."""
    if mode == "train" and generator is not None:
        return random_crop_image_batch(generator, images, target_shape)
    return center_crop_image_batch(images, target_shape)


def _triangle_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in, out] weights of jax.image.resize's antialiased linear
    (triangle) kernel along one dimension (scale = out / in, no
    translation): the kernel widens by in / out when downsampling, each
    column is normalized, and samples outside the input get weight 0."""
    scale = torch.tensor(out_size / in_size, dtype=torch.float32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None])
    weights = torch.clamp_min(1.0 - x / kernel_scale, 0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        0.0,
    )
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0).to(device)


def resize_image_batch(images: torch.Tensor, target_shape: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] images with jax.image.resize's
    antialiased linear kernel (a dimension whose size is kept is left as
    it is)."""
    th, tw = int(target_shape[0]), int(target_shape[1])
    h, w = images.shape[-3], images.shape[-2]
    out = images
    if th != h:
        out = torch.einsum("...hwc,ho->...owc",
                           out, _triangle_weights(h, th, images.device).to(out.dtype))
    if tw != w:
        out = torch.einsum("...hwc,wo->...hoc",
                           out, _triangle_weights(w, tw, images.device).to(out.dtype))
    return out


def preprocess_image(
    images: torch.Tensor,
    mode: str,
    generator: Optional[torch.Generator] = None,
    is_training: Optional[bool] = None,
    crop_size: Optional[Sequence[int]] = None,
    target_size: Optional[Sequence[int]] = None,
    distort: bool = False,
    **distortion_kwargs,
) -> torch.Tensor:
    """uint8 -> float [0, 1] -> crop -> distort (train) -> resize, over
    [B, H, W, C] or [B, T, H, W, C] (time folded into the batch and back).
    The crop draws from `generator` before the distortion does."""
    del is_training  # mode is authoritative; kept for call-site parity
    original_shape = images.shape
    if images.ndim == 5:
        images = images.reshape((-1,) + tuple(images.shape[2:]))
    if images.dtype == torch.uint8:
        images = uint8_to_float(images)
    if crop_size is not None:
        images = crop_image_batch(generator, images, crop_size, mode)
    if distort and mode == "train" and generator is not None:
        images = apply_photometric_image_distortions(
            generator, images, **distortion_kwargs
        )
    if target_size is not None:
        images = resize_image_batch(images, target_size)
    if len(original_shape) == 5:
        images = images.reshape(tuple(original_shape[:2]) + tuple(images.shape[1:]))
    return images
