"""Grasp2Vec heatmap and keypoint visualizations.

Port of tensor2robot_tpu/research/grasp2vec/visualization.py. The heatmap
math runs in torch on the embeddings' device; the rasterization is numpy
on the host (visualization only). The functions return image arrays for
the caller to write.
"""

from __future__ import annotations

import colorsys
from typing import Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.layers.spatial_softmax import spatial_softmax


def compute_heatmap(feature_query: torch.Tensor,
                    feature_map: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dot product of a query embedding [B, D] over a spatial feature map
    [B, h, w, D]. Returns (heatmaps [B, h, w, 1], softmaxed heatmaps
    [B, h, w, 1]); the softmax runs over all h * w positions."""
    batch, dim = feature_query.shape
    heatmaps = torch.sum(feature_map * feature_query.reshape(batch, 1, 1, dim),
                         dim=3, keepdim=True)
    softmaxed = torch.softmax(heatmaps.reshape(batch, -1), dim=-1)
    return heatmaps, softmaxed.reshape(heatmaps.shape)


def heatmap_soft_argmax(heatmaps: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """Expected (x, y) location in [-1, 1] of a [B, h, w, 1] heatmap, as
    [B, 1, 2]."""
    points, _ = spatial_softmax(heatmaps, temperature=temperature)
    return points[:, None, :]


def np_render_keypoints(image: np.ndarray, locations: np.ndarray,
                        num_images: int = 3, dot_radius: int = 3) -> np.ndarray:
    """Rasterizes soft-argmax locations as colored dots on greyed images."""
    num_images = min(num_images, image.shape[0])
    _, h, w, _ = image.shape
    mx, my = np.meshgrid(np.arange(w), np.arange(h))
    num_points = locations.shape[1]
    images = []
    for i in range(num_images):
        img = np.tile(np.mean(image[i], axis=2, keepdims=True), [1, 1, 3])
        img = img / 2.0 + 0.4
        hues = np.linspace(0, 1, num_points + 1)[:-1]
        colors = [np.array(colorsys.hsv_to_rgb(h_, 1.0, 0.9)) for h_ in hues]
        xs = np.round((locations[i, :, 0] + 1.0) * w / 2.0).astype(int)
        ys = np.round((locations[i, :, 1] + 1.0) * h / 2.0).astype(int)
        for x, y, color in zip(xs, ys, colors):
            dist = np.sqrt((x - mx) ** 2 + (y - my) ** 2)
            weight = np.tile(np.clip(dot_radius - dist, 0.0, 1.0)[:, :, None], [1, 1, 3])
            img = img * (1 - weight) + weight * color.reshape(1, 1, 3)
        images.append((img * 255).astype(np.uint8))
    return np.stack(images, 0)


def _resize_nearest(x: np.ndarray, height: int, width: int) -> np.ndarray:
    """Nearest resize of [B, h, w, C] to [B, height, width, C] with
    half-pixel centers (jax.image.resize's "nearest")."""
    rows = np.floor((np.arange(height) + 0.5) * x.shape[1] / height).astype(int)
    cols = np.floor((np.arange(width) + 0.5) * x.shape[2] / width).astype(int)
    return x[:, rows][:, :, cols]


def get_softmax_viz(image: np.ndarray, softmax: np.ndarray,
                    nrows: Optional[int] = None) -> np.ndarray:
    """Arranges softmax maps in a grid superimposed on the greyscale image
    by an HSV encoding."""
    batch, sh, sw, num_points = softmax.shape
    th, tw = sh * 2, sw * 2
    if nrows is None:
        divs = [d for d in range(1, int(np.sqrt(num_points)) + 1) if num_points % d == 0]
        nrows = max(divs) if divs else 1
    ncols = num_points // nrows

    img = softmax / np.maximum(softmax.max(axis=(1, 2), keepdims=True), 1e-12)
    grey = _resize_nearest(np.mean(image, axis=3, keepdims=True), th, tw)
    grey = np.tile(grey, [1, 1, 1, num_points])[..., None]
    img = _resize_nearest(img, th, tw)[..., None]
    hsv = np.concatenate([img / 2.0 + 0.5, img, grey * 0.7 + 0.3], axis=4)
    hsv = hsv.reshape(batch, th, tw, nrows, ncols, 3)
    hsv = hsv.transpose(0, 3, 1, 4, 2, 5).reshape(batch, th * nrows, tw * ncols, 3)
    h_, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h_ * 6.0) % 6
    f = h_ * 6.0 - np.floor(h_ * 6.0)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    return np.select(
        [i[..., None] == k for k in range(6)],
        [np.stack(c, axis=-1)
         for c in [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]],
    )
