"""Non-overlapping max pooling (stride == window) with TF padding.

Port of tensor2robot_tpu/ops/pooling.py over NCHW tensors. Every pool of
the Grasping44 tower is of this form.

Padding. `SAME` gives ceil(n / s) outputs and pads with -inf, the odd
pixel AFTER: lo = total // 2, hi = total - lo, total = max((out - 1) * s
+ w - n, 0). torch's max_pool2d pads symmetrically and its ceil_mode starts
the windows at 0, which differ: 236 -> 79 with 3x3 pads (0, 1), 79 -> 27
pads (1, 1). So SAME pads explicitly with -inf before a VALID max_pool2d.
`VALID` drops the trailing remainder.

Backward. Where a window holds several elements equal to its maximum
(common after a relu: exact zeros), the JAX package off the TPU (and this
port by default) splits the incoming gradient EQUALLY among them, the
subgradient jnp.max's gradient takes; max_pool2d's own backward routes it
all to one element. `T2R_POOL_BACKWARD=native` selects the latter (the
TPU's SelectAndScatter choice); `auto` and `scatterfree` select the equal
split. Both are valid subgradients of the same forward.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tensor2robot_tpu_torch import flags


def resolve_backward_mode() -> str:
    """T2R_POOL_BACKWARD as the path taken: 'native' (max_pool2d's
    backward) or 'scatterfree' (the equal split, also what 'auto' takes:
    the JAX package's auto picks native only on a TPU)."""
    mode = flags.get_enum("T2R_POOL_BACKWARD")
    return "native" if mode == "native" else "scatterfree"


def same_pads(size: int, window: int) -> Tuple[int, int]:
    """(low, high) -inf padding of one dim for a SAME pool with stride ==
    window."""
    out = -(-size // window)
    total = max((out - 1) * window + window - size, 0)
    return total // 2, total - total // 2


def _padded(x: torch.Tensor, window: Tuple[int, int], padding: str):
    """x cut (VALID) or -inf padded (SAME) to whole windows."""
    wh, ww = window
    h, w = x.shape[2], x.shape[3]
    if padding == "VALID":
        return x[:, :, :h // wh * wh, :w // ww * ww]
    if padding != "SAME":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    (top, bottom), (left, right) = same_pads(h, wh), same_pads(w, ww)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return x


def tie_routing(x: torch.Tensor, window: Tuple[int, int], padding: str):
    """(mask, count) of the equal split: over x's windows [B, C, oh, wh,
    ow, ww], which elements equal their window's maximum, and how many
    (>= 1) each window holds."""
    wh, ww = window
    xp = _padded(x, window, padding)
    b, c, hp, wp = xp.shape
    windows = xp.reshape(b, c, hp // wh, wh, wp // ww, ww)
    mask = windows == windows.amax(dim=(3, 5), keepdim=True)
    return mask, mask.sum(dim=(3, 5), keepdim=True)


def route_gradient(g, mask, count, x_shape, window, padding) -> torch.Tensor:
    """The pool's input gradient: each window's gradient g split over
    `mask` in `count` equal shares, in the layout of the input."""
    b, c, oh, wh, ow, ww = mask.shape
    share = (g[:, :, :, None, :, None] / count.to(g.dtype)) * mask
    gx = share.reshape(b, c, oh * wh, ow * ww)
    h, w = x_shape[2], x_shape[3]
    if padding == "VALID":
        return F.pad(gx, (0, w - ow * ww, 0, h - oh * wh))
    top, left = same_pads(h, window[0])[0], same_pads(w, window[1])[0]
    return gx[:, :, top:top + h, left:left + w]


class _EqualSplitMaxPool(torch.autograd.Function):
    """Forward: the window maxima. Backward: each window's gradient split
    equally over the elements equal to its maximum, recomputed from the
    same windows the mask compares against (so each window counts >= 1)."""

    @staticmethod
    def forward(ctx, x, window, padding):
        ctx.save_for_backward(x)
        ctx.window, ctx.padding = window, padding
        xp = _padded(x, window, padding)
        return F.max_pool2d(xp, window, window)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        mask, count = tie_routing(x, ctx.window, ctx.padding)
        gx = route_gradient(g, mask, count, x.shape, ctx.window, ctx.padding)
        return gx.to(x.dtype), None, None


def max_pool(
    x: torch.Tensor, window: Tuple[int, int], padding: str = "SAME"
) -> torch.Tensor:
    """Max pool of an NCHW tensor with stride == window; the backward is
    T2R_POOL_BACKWARD's (module docstring)."""
    window = (int(window[0]), int(window[1]))
    padding = padding.upper()
    if resolve_backward_mode() == "native":
        xp = _padded(x, window, padding)
        return F.max_pool2d(xp, window, window)
    return _EqualSplitMaxPool.apply(x, window, padding)
