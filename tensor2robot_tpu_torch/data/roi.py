"""Decode-time region-of-interest (ROI) descriptors.

Port of tensor2robot_tpu/data/roi.py. The QT-Opt pipeline decodes 512x640
frames and crops them to 472x472: a `DecodeROI` moves the crop to decode
time, so the parser decodes only the crop window (data/csrc's
`t2r_decode_jpeg_roi`) and batches arrive with the cropped shape.

Semantics are crop-equivalence, pixel for pixel: for a given offset the
ROI-decoded window equals a full decode followed by the same crop. The
offsets come from the host: static center offsets for eval, per-record
random offsets drawn before decode for training, from the dataset's
`np.random.default_rng(seed)`, so the same seed gives the JAX package's
crops.

  * `DecodeROI`: a declarative request on one image spec key ("crop this
    field to (h, w); offsets random/center/fixed").
  * `ResolvedROI`: one batch's concrete per-record offsets, resolved once
    per chunk in the dataset (`resolve_decode_rois`); the same offsets go
    to whichever parser handles the batch, so an oracle re-parse after a
    fast-path failure gives the same batch.
  * `apply_roi_to_batch`: the oracle's implementation, full decode then a
    per-record numpy crop. This is the semantics ROI decode must match.

Only non-sequence single-image specs (rank 3, static H/W/C, `data_format`
set) accept a DecodeROI; image stacks and sequence image fields keep
full-frame decode.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, flatten_spec_structure

__all__ = [
    "DecodeROI",
    "ResolvedROI",
    "normalize_decode_rois",
    "resolve_decode_rois",
    "apply_roi_to_batch",
    "adjust_spec_for_roi_tensors",
]

_MODES = ("random", "center", "fixed")


@dataclass(frozen=True)
class DecodeROI:
    """Declarative decode-time crop for one image spec.

    mode:
      'random' — per-record uniform offsets over the valid range (the
        training crop; drawn from the dataset RNG before decode).
      'center' — static centered offsets (the eval crop).
      'fixed'  — explicit (y, x) offsets, same for every record.
    """

    height: int
    width: int
    mode: str = "center"
    y: Optional[int] = None
    x: Optional[int] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"DecodeROI mode must be one of {_MODES}, got {self.mode!r}"
            )
        if self.height <= 0 or self.width <= 0:
            raise ValueError(
                f"DecodeROI size must be positive, got "
                f"({self.height}, {self.width})"
            )
        if self.mode == "fixed" and (self.y is None or self.x is None):
            raise ValueError("DecodeROI mode 'fixed' requires y and x.")


@dataclass(frozen=True)
class ResolvedROI:
    """One batch's concrete crop: per-record offsets + the window size.

    `randomized` records whether the offsets came from a random draw —
    the decode cache keys off it (random offsets rarely repeat, so the
    cache stores the full frame and serves window slices; static offsets
    repeat every epoch, so it stores the ~45%-smaller cropped window).
    """

    height: int
    width: int
    ys: np.ndarray  # (n,) int64
    xs: np.ndarray  # (n,) int64
    randomized: bool = False

    def rect(self, i: int) -> Tuple[int, int, int, int]:
        return int(self.ys[i]), int(self.xs[i]), self.height, self.width


def _eligible_image_spec(spec) -> bool:
    return (
        isinstance(spec, ExtendedTensorSpec)
        and spec.data_format is not None
        and not spec.is_sequence
        and len(spec.shape) == 3
        and all(d is not None for d in spec.shape)
    )


def normalize_decode_rois(
    rois: Mapping[str, DecodeROI], specs
) -> Dict[str, DecodeROI]:
    """Validates a {flat spec key: DecodeROI} map against a spec structure.

    Fails fast on unknown keys, non-image or sequence/stack specs, and
    crops larger than the source — a typo'd ROI must not silently decode
    full frames (or worse, crash mid-epoch in a worker process).
    """
    flat = flatten_spec_structure(specs)
    out: Dict[str, DecodeROI] = {}
    for key, roi in rois.items():
        if not isinstance(roi, DecodeROI):
            raise TypeError(f"decode_roi[{key!r}] must be DecodeROI, got {roi!r}")
        spec = flat.get(key)
        if spec is None:
            raise KeyError(
                f"decode_roi key {key!r} not in specs "
                f"(known: {sorted(flat.keys())[:20]})"
            )
        if not _eligible_image_spec(spec):
            raise ValueError(
                f"decode_roi key {key!r} must be a non-sequence single-image "
                f"spec with static H/W/C, got shape {tuple(spec.shape)} "
                f"data_format={spec.data_format!r} "
                f"is_sequence={spec.is_sequence}"
            )
        src_h, src_w = int(spec.shape[0]), int(spec.shape[1])
        if roi.height > src_h or roi.width > src_w:
            raise ValueError(
                f"decode_roi[{key!r}] crop ({roi.height}, {roi.width}) "
                f"exceeds source ({src_h}, {src_w})"
            )
        if roi.mode == "fixed" and (
            roi.y + roi.height > src_h or roi.x + roi.width > src_w
        ):
            raise ValueError(
                f"decode_roi[{key!r}] fixed offset ({roi.y}, {roi.x}) + crop "
                f"exceeds source ({src_h}, {src_w})"
            )
        out[key] = roi
    return out


def resolve_decode_rois(
    rois: Mapping[str, DecodeROI],
    specs,
    n: int,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, ResolvedROI]:
    """Draws one batch's offsets — ONCE, shared by fast path and oracle."""
    flat = flatten_spec_structure(specs)
    out: Dict[str, ResolvedROI] = {}
    for key, roi in rois.items():
        spec = flat[key]
        src_h, src_w = int(spec.shape[0]), int(spec.shape[1])
        if roi.mode == "random":
            if rng is None:
                rng = np.random.default_rng()
            ys = rng.integers(0, src_h - roi.height + 1, size=n, dtype=np.int64)
            xs = rng.integers(0, src_w - roi.width + 1, size=n, dtype=np.int64)
            randomized = True
        else:
            if roi.mode == "center":
                y, x = (src_h - roi.height) // 2, (src_w - roi.width) // 2
            else:
                y, x = int(roi.y), int(roi.x)
            ys = np.full(n, y, np.int64)
            xs = np.full(n, x, np.int64)
            randomized = False
        out[key] = ResolvedROI(roi.height, roi.width, ys, xs, randomized)
    return out


def adjust_spec_for_roi_tensors(spec_struct, rois, tensors):
    """In-spec variant accepting decode-ROI'd inputs where they arrive.

    A preprocessor that declares decode ROIs consumes EITHER the on-disk
    source shape (direct feeds, T2R_DECODE_ROI=0 pipelines — it then
    crops on device) or the already-cropped shape (a ROI-decoding
    RecordDataset). Validation must accept both without loosening
    anything else: for each ROI key whose incoming tensor already has the
    crop's (H, W), the returned copy declares that shape; every other
    key — and every mismatched shape — keeps the strict source spec, so
    genuinely wrong inputs still fail loudly.
    """
    flat_spec = flatten_spec_structure(spec_struct)
    flat_tensors = flatten_spec_structure(tensors)
    adjusted = None
    for key, roi in rois.items():
        spec = flat_spec.get(key)
        tensor = flat_tensors.get(key)
        if spec is None or tensor is None or not _eligible_image_spec(spec):
            continue
        shape = tuple(getattr(tensor, "shape", ()))
        cropped = (roi.height, roi.width, int(spec.shape[2]))
        if shape[-3:] == cropped and cropped != tuple(
            int(d) for d in spec.shape
        ):
            if adjusted is None:
                adjusted = spec_struct.copy()
            adjusted[key] = ExtendedTensorSpec.from_spec(spec, shape=cropped)
    return spec_struct if adjusted is None else adjusted


def apply_roi_to_batch(batch, resolved: Mapping[str, ResolvedROI]):
    """Oracle-side crop: per-record window slices of fully-decoded fields.

    This is the ground-truth semantics of decode-time ROI — identical
    pixels via full decode + crop. Used by `SpecParser.parse_batch` so a
    fast-path fallback reproduces the exact batch the fast path would
    have produced (same resolved offsets).
    """
    for key, roi in resolved.items():
        if key not in batch:
            continue
        arr = np.asarray(batch[key])
        n = arr.shape[0]
        if len(roi.ys) != n:
            raise ValueError(
                f"ResolvedROI for {key!r} has {len(roi.ys)} offsets, batch "
                f"holds {n} records"
            )
        out = np.empty(
            (n, roi.height, roi.width) + arr.shape[3:], dtype=arr.dtype
        )
        for i in range(n):
            y, x = int(roi.ys[i]), int(roi.xs[i])
            out[i] = arr[i, y : y + roi.height, x : x + roi.width]
        batch[key] = out
    return batch
