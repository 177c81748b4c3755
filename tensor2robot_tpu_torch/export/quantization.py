"""Weight-only int8 and int4 quantization for exported models.

Port of tensor2robot_tpu/export/quantization.py. Robot fleets poll and
download every export version, so artifact size is restore latency:
symmetric per-output-channel int8 on the large matmul and conv kernels
cuts them ~4x (int4 ~8x); serving dequantizes on the fly, so compute
stays f32 and the error is the weights' rounding alone.

A quantized state dict keeps its keys; each quantized leaf becomes a
{Q_KEY: int8 tensor, SCALE_KEY: f32 per-channel scales, AXIS_KEY: the
channel axis} dict node (int4: Q4_KEY packed uint8 and Q4_SHAPE_KEY in
place of Q_KEY), which `torch.save` and `torch.load(weights_only=True)`
carry as they are.

Layout. The JAX package scales per output channel along a leaf's LAST
axis, because flax stores a Dense kernel [in, out] and a conv kernel
HWIO. The port's Linear weight is [out, in] and its Conv2d weight
[O, I, H, W], so for those (a `weight` of rank 2 or 4, what
utils/jax_params.py makes of a flax `kernel`) the channel is axis 0; any
other leaf (e.g. `encoder.pos_embedding`) has flax's layout and keeps the
last axis. So a leaf of either package and its converted twin quantize to
the same values. Within a leaf the arithmetic is the JAX package's, in
float32: scale = max(max|w| / 127, 1e-12) (7 for int4), q = clip(round(w
/ scale)), w' = q * scale.

The int4 packing is the port's own: the leaf in its C order, biased by +8,
padded to even length, even indices in the low nibble.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

Q_KEY = "__t2r_int8_q__"
SCALE_KEY = "__t2r_int8_scale__"
Q4_KEY = "__t2r_int4_packed__"
Q4_SHAPE_KEY = "__t2r_int4_shape__"
AXIS_KEY = "__t2r_channel_axis__"

#: Leaves smaller than this stay f32: quantizing a bias or a LayerNorm
#: scale saves nothing and costs accuracy where 8 bits hurt most.
DEFAULT_MIN_SIZE = 1024


def check_bits(bits: int) -> int:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return bits


def channel_axis(name: str, ndim: int) -> int:
    """The output-channel axis of the leaf `name` (module docstring)."""
    if name.rsplit(".", 1)[-1] == "weight" and ndim in (2, 4):
        return 0
    return ndim - 1


def is_quantized_node(node: Any) -> bool:
    return isinstance(node, Mapping) and SCALE_KEY in node and (
        Q_KEY in node or Q4_KEY in node
    )


def _scaled(leaf: np.ndarray, axis: int, levels: float):
    """(q as int8 in [-levels, levels], scale f32 [C]) along `axis`."""
    reduce_axes = tuple(d for d in range(leaf.ndim) if d != axis)
    max_abs = np.max(np.abs(leaf), axis=reduce_axes)
    scale = np.maximum(max_abs / levels, 1e-12).astype(np.float32)
    shape = [1] * leaf.ndim
    shape[axis] = -1
    q = np.clip(np.round(leaf / scale.reshape(shape)), -levels, levels)
    return q.astype(np.int8), scale


def quantize_leaf(leaf: torch.Tensor, axis: int, bits: int = 8) -> Dict[str, torch.Tensor]:
    """A quantized node of one float leaf, per channel along `axis`."""
    # C order, so the stored tensors are contiguous whatever the leaf's
    # strides (torch.export.save keeps only whole contiguous storages).
    array = np.ascontiguousarray(leaf.detach().cpu().float().numpy())
    q, scale = _scaled(array, axis, 127.0 if check_bits(bits) == 8 else 7.0)
    node = {
        SCALE_KEY: torch.from_numpy(scale),
        AXIS_KEY: torch.tensor(axis, dtype=torch.int64),
    }
    if bits == 8:
        node[Q_KEY] = torch.from_numpy(q)
        return node
    flat = (q.reshape(-1) + 8).astype(np.uint8)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros((1,), np.uint8)])
    pairs = flat.reshape(-1, 2)
    node[Q4_KEY] = torch.from_numpy((pairs[:, 0] | (pairs[:, 1] << 4)).astype(np.uint8))
    node[Q4_SHAPE_KEY] = torch.tensor(array.shape, dtype=torch.int32)
    return node


def quantizes(name: str, leaf: torch.Tensor, min_size: int) -> bool:
    """Whether a leaf qualifies: float, rank >= 2, >= min_size elements."""
    return leaf.is_floating_point() and leaf.ndim >= 2 and leaf.numel() >= min_size


def quantize_variables(
    variables: Mapping[str, torch.Tensor],
    min_size: int = DEFAULT_MIN_SIZE,
    bits: int = 8,
) -> Tuple[Dict[str, Any], int]:
    """Returns (quantized state dict, number of quantized leaves). Leaves
    that do not qualify (biases, norms, batch-norm statistics, integer
    state) pass through as they are."""
    check_bits(bits)
    out: Dict[str, Any] = {}
    count = 0
    for name, leaf in variables.items():
        if quantizes(name, leaf, min_size):
            out[name] = quantize_leaf(leaf, channel_axis(name, leaf.ndim), bits)
            count += 1
        else:
            out[name] = leaf
    return out, count


def dequantize(values: torch.Tensor, scale: torch.Tensor, axis: int,
               shape=None, dtype=torch.float32) -> torch.Tensor:
    """q * scale along `axis`; with `shape`, `values` is int4-packed and
    unpacked to it first. Torch ops over static axis and shape, so it
    traces into an exported program."""
    if shape is not None:
        flat = torch.stack([values & 0xF, values >> 4], dim=-1).reshape(-1)
        values = flat[: int(np.prod(shape))].to(torch.int32) - 8
        values = values.reshape(tuple(shape))
    view = [1] * values.ndim
    view[axis] = -1
    return values.to(dtype) * scale.to(dtype).reshape(view)


def node_layout(node: Mapping[str, torch.Tensor]):
    """(stored values, scale, channel axis, int4 shape or None) of a node."""
    if Q4_KEY in node:
        shape = tuple(int(d) for d in node[Q4_SHAPE_KEY].tolist())
        return node[Q4_KEY], node[SCALE_KEY], int(node[AXIS_KEY]), shape
    return node[Q_KEY], node[SCALE_KEY], int(node[AXIS_KEY]), None


def dequantize_leaf(node: Mapping[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """The float leaf of a quantized node."""
    values, scale, axis, shape = node_layout(node)
    return dequantize(values, scale, axis, shape, dtype)


def dequantize_variables(variables: Mapping[str, Any], dtype=torch.float32) -> Dict[str, Any]:
    """Inverse of quantize_variables (up to the weights' rounding)."""
    return {
        name: dequantize_leaf(node, dtype) if is_quantized_node(node) else node
        for name, node in variables.items()
    }


def is_quantized(variables: Mapping[str, Any]) -> bool:
    """True if any leaf is a quantized node."""
    return any(is_quantized_node(node) for node in variables.values())
