"""Low-precision serving payloads and native int8/fp8 contractions.

Port of tensor2robot_tpu/export/serve_quant.py. An export may carry, beside
its f32 program, one program per serving regime ("fp16", "int8",
"fp8_e4m3", "fp8_e5m2"; the gradient codecs' names) that takes the
regime's quantized payload as an ARGUMENT, so the program carries no
weights:

  * `quantize_tree` encodes the export's variables, taken in the flax
    layout and keyed by JAX's flat flax paths (`flax_variables`), through
    the gradient codecs of parallel/collectives.py (one wire format for
    both legs): blockwise over each raveled leaf, or, for the leaves of
    the eligibility map, per output channel in the leaf's own shape.
    Values, scales, block boundaries and the layout dict equal the JAX
    package's;
  * `dequantize_tree` is torch ops, so it traces into the program;
  * native contractions: an eligible Linear or Conv whose payload leaf is
    channel-quantized contracts the stored int8/fp8 operands with the
    activation quantized per row (dense), per sample (conv) or against a
    static export-calibrated clip, and both scales multiply the
    accumulator (int32 for int8, exactly; f32 for fp8). The einsum-path
    attention modules run QK^T and PV on quantized operands through
    ops/flash_attention's contraction override; flash heads never lower;
  * calibration (`calibrate_activations` at the inputs,
    `capture_activations` + `calibrate_layer_activations` +
    `resolve_static_scales` inside), the parity gate (`measure_parity`,
    `check_parity`), and the audits of the exported program's graph
    (`audit_dot_dtypes`, `audit_quant_reduces`).

Where the JAX package intercepts flax module calls (nn.intercept_methods),
the port swaps modules in the serving module's own copy of the network
(`native_lowering`): an eligible module's class becomes its native
subclass, which reads the stored operands from the payload the call was
given and records itself in `fired` when it runs. A kernel that no Linear
or Conv owns (the experts' 3-D kernels), a conv whose configuration the
native path does not reproduce (non-zero padding modes, groups), or a
module that never runs stays on the dequant path and is listed under
`unlowered` by the export, as in the JAX package.

The contractions on the card and on the CPU (`quant_mm`):
  * int8: `torch._int_mm`; 16 zero rows appended (it takes more than 16
    rows), K and N padded to multiples of 8 (cuBLASLt's rule; zero
    padding is exact under per-row scales), the second operand
    column-major (cuBLASLt's int8 kernels refuse some shapes otherwise);
  * fp8_e4m3: `torch._scaled_mm` with unit scales and f32 output; K and N
    padded to multiples of 16, the second operand column-major. On the
    H100 the fp8 tensor cores sum each MMA's products at reduced
    precision before cuBLASLt promotes them to f32, so this route's sums
    are not f32 to the last bit (the JAX package's are);
  * fp8_e5m2: cuBLASLt multiplies no two e5m2 matrices, so on the card
    both operands are upcast to f16 (every e5m2 value is an f16 value) and
    multiplied by `torch.mm(..., out_dtype=torch.float32)`: exact products,
    f32 sums. On the CPU `torch._scaled_mm` takes e5m2 as it is;
  * convs by im2col: the quantized input is unfolded (through f16, which
    holds every int8 and fp8 value exactly) and contracted as a dense;
  * attention's batched QK^T and PV through the operator
    `t2r_torch::quant_bmm`, one 2-D contraction per batch x head slice.
The padding is the same on both devices, so an int8 or e4m3 program
traced on one device serves on the other; the e5m2 route is the device's.
"""

from __future__ import annotations

import contextlib
import fnmatch
import io
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.parallel.collectives import (
    Fp8E4M3Collective,
    Fp8E5M2Collective,
    get_collective,
)

__all__ = [
    "QuantParityError",
    "CalibrationError",
    "SERVE_QUANT_REGIMES",
    "NATIVE_DOT_REGIMES",
    "CALIB_MODES",
    "GRAN_BLOCK",
    "GRAN_CHANNEL",
    "DEFAULT_BLOCK",
    "DEFAULT_MIN_SIZE",
    "DEFAULT_PARITY_TOL",
    "DEFAULT_STATIC_OVERSHOOT",
    "Q_KEY",
    "S_KEY",
    "quantize_tree",
    "dequantize_tree",
    "default_native_eligibility",
    "resolve_native_eligibility",
    "resolve_native_attention",
    "resolve_calib_mode",
    "attn_key",
    "native_dot",
    "native_conv",
    "native_lowering",
    "audit_dot_dtypes",
    "audit_quant_reduces",
    "capture_activations",
    "calibrate_activations",
    "calibrate_layer_activations",
    "resolve_static_scales",
    "fake_quant_activations",
    "measure_parity",
    "check_parity",
    "payload_nbytes",
    "tree_nbytes",
]

#: The serve-side regimes; the collective registry's quantized formats.
SERVE_QUANT_REGIMES = ("fp16", "int8", "fp8_e4m3", "fp8_e5m2")

#: fp8 storage formats: regime -> (dtype, largest finite value), read off
#: the codecs so the two modules cannot drift apart on a format. The clip
#: before every cast is load-bearing: an overflowing cast is NaN.
_FP8_FORMATS = {
    "fp8_e4m3": (Fp8E4M3Collective._DTYPE, Fp8E4M3Collective._MAX),
    "fp8_e5m2": (Fp8E5M2Collective._DTYPE, Fp8E5M2Collective._MAX),
}

#: Regimes whose eligible kernels contract natively on the storage dtype
#: (fp16 is a cast regime: the dequant path already runs it).
NATIVE_DOT_REGIMES = ("int8", "fp8_e4m3", "fp8_e5m2")

#: 'static' bakes export-time per-layer clips into the program (zero
#: per-dispatch quant reduces); 'dynamic' quantizes per row or sample.
CALIB_MODES = ("static", "dynamic")

#: A layer whose warmup max-abs overshoots its percentile clip by more
#: than this relative fraction keeps the dynamic quant.
DEFAULT_STATIC_OVERSHOOT = 0.5

#: The percentile both calibrators clip at.
DEFAULT_CALIB_PERCENTILE = 99.9

#: Least contraction depth (kernel rows) for native eligibility: a
#: per-channel scale costs 4 bytes over `rows` 1-byte values.
DEFAULT_MIN_NATIVE_ROWS = 16

#: Payload granularities recorded per leaf in the layout.
GRAN_BLOCK = "block"
GRAN_CHANNEL = "channel"

#: Elements per scale (the gradient codecs' default block).
DEFAULT_BLOCK = 512

#: Float leaves below this many elements stay f32.
DEFAULT_MIN_SIZE = 16

#: The export-time parity gate: max |quant - fp32| over the warmup
#: corpus, per flat output key.
DEFAULT_PARITY_TOL = {
    "fp16": 1e-2,
    "int8": 2e-1,
    "fp8_e4m3": 2.5e-1,
    "fp8_e5m2": 5e-1,
}

# Sentinel node keys of the stored payload tree.
Q_KEY = "__t2r_sq_q__"
S_KEY = "__t2r_sq_s__"

#: Per-call cap on captured |activation| samples; above it the pool is
#: stride-subsampled with the call's true max appended.
CAPTURE_SAMPLES_PER_CALL = 1 << 16


class QuantParityError(RuntimeError):
    """The quantized serving module diverged from the fp32 forward beyond
    the declared tolerance on the warmup corpus; the export must not land."""


class CalibrationError(ValueError):
    """The warmup corpus cannot calibrate activation scales (empty, or a
    batch carries NaN/Inf); raised before the parity gate, naming the key."""


def resolve_calib_mode(mode: Optional[str] = None) -> str:
    """The activation-calibration mode; None reads T2R_SERVE_CALIB."""
    if mode is None:
        from tensor2robot_tpu_torch import flags

        return flags.get_enum("T2R_SERVE_CALIB")
    if mode not in CALIB_MODES:
        raise ValueError(
            f"calibration mode must be one of {CALIB_MODES}, got "
            f"{mode!r} (T2R_SERVE_CALIB selects the serving calibration "
            "mode)"
        )
    return mode


def _is_payload_node(node: Any) -> bool:
    return isinstance(node, Mapping) and Q_KEY in node and S_KEY in node


def _leaf_block(size: int, block: int) -> int:
    """A leaf smaller than one block is covered by one leaf-sized block."""
    return block if size >= block else size


def _levels(regime: str) -> float:
    """Largest encodable magnitude of the regime's storage dtype."""
    if regime == "int8":
        return 127.0
    return _FP8_FORMATS[regime][1]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# -- the flax view of a torch network ------------------------------------------


def variable_entries(network: nn.Module) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """(state-dict name, JAX flat path, dims) of every parameter and
    persistent buffer of `network`: parameters under 'params/' at their
    flax paths (utils/keypath.py), buffers (batch-norm statistics) under
    'batch_stats/'. The torch entry is its flax leaf permuted by `dims`."""
    from tensor2robot_tpu_torch.utils.jax_params import flax_dims
    from tensor2robot_tpu_torch.utils.keypath import flax_parameter_paths

    entries = []
    for name, path in flax_parameter_paths(network).items():
        ndim = network.get_parameter(name).ndim
        kernel = path.rsplit("/", 1)[-1] == "kernel"
        dims = flax_dims(name, ndim) if kernel else tuple(range(ndim))
        entries.append((name, "params/" + path, dims))
    persistent = set(network.state_dict(keep_vars=True))
    for name, buffer in network.named_buffers():
        if name in persistent:
            entries.append((name, "batch_stats/" + name.replace(".", "/"),
                            tuple(range(buffer.ndim))))
    return entries


def flax_variables(variables: Mapping[str, torch.Tensor],
                   network: nn.Module) -> Dict[str, Any]:
    """The state dict `variables` of `network` as the JAX package's
    variables tree: nested dicts of numpy arrays in the flax layout (a
    Linear weight as its [in, out] kernel, a conv's as HWIO)."""
    tree: Dict[str, Any] = {}
    for name, path, dims in variable_entries(network):
        if name not in variables:
            continue
        leaf = _host(variables[name]).transpose(np.argsort(dims))
        node = tree
        *parents, last = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = np.ascontiguousarray(leaf)
    return tree


def _flat_items(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping) and not _is_payload_node(value):
            yield from _flat_items(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


# -- the payload ----------------------------------------------------------------


def _channel_encode(leaf: np.ndarray, regime: str) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric encode of an [..., out] kernel (flax
    layout): one scale per output channel, values in the leaf's shape."""
    absmax = np.max(np.abs(leaf), axis=tuple(range(leaf.ndim - 1)))
    absmax = np.where(absmax > 0, absmax, 1.0).astype(np.float32)
    scale = absmax / _levels(regime)
    if regime == "int8":
        return np.clip(np.round(leaf / scale), -127, 127).astype(np.int8), scale
    dtype, fmax = _FP8_FORMATS[regime]
    return torch.from_numpy(np.clip(leaf / scale, -fmax, fmax)).to(dtype), scale


def quantize_tree(
    variables: Any,
    regime: str,
    block: int = DEFAULT_BLOCK,
    min_size: int = DEFAULT_MIN_SIZE,
    native: Sequence[str] = (),
) -> Tuple[Any, Dict[str, Dict[str, Any]]]:
    """Encodes eligible float leaves of a flax-layout variables tree
    (`flax_variables`) through the regime's codec.

    Returns (payload tree, layout). The payload mirrors the nesting; each
    quantized leaf becomes {Q_KEY: values, S_KEY: f32 scales} (int8,
    fp16 or fp8 values), every other leaf passes through as a tensor.
    `layout` maps the flat '/'-joined path to {'shape', 'size',
    'granularity'} and, for blockwise leaves, 'block' and 'padded'.
    Leaves of `native` (flat paths, `resolve_native_eligibility`) are
    encoded per output channel in their own shape; the rest raveled in C
    order of the flax layout, padded to the block, through the codec."""
    if regime not in SERVE_QUANT_REGIMES:
        raise ValueError(
            f"serve-quant regime must be one of {SERVE_QUANT_REGIMES}, "
            f"got {regime!r} (T2R_SERVE_QUANT selects the serving regime)"
        )
    native = frozenset(native)
    if native and regime not in NATIVE_DOT_REGIMES:
        raise ValueError(
            f"native eligibility given for regime {regime!r}, but only "
            f"{NATIVE_DOT_REGIMES} have a native dot lowering"
        )
    layout: Dict[str, Dict[str, Any]] = {}
    seen: set = set()

    def walk(node, path):
        if isinstance(node, Mapping):
            return {key: walk(value, path + (key,)) for key, value in node.items()}
        leaf = _host(node)
        flat_path = "/".join(path)
        floating = np.issubdtype(leaf.dtype, np.floating)
        if flat_path in native:
            seen.add(flat_path)
            if not (floating and leaf.ndim in (2, 3, 4)):
                raise ValueError(
                    f"native-eligible leaf {flat_path!r} must be a 2-D "
                    f"dense or 3/4-D conv float kernel, got shape "
                    f"{leaf.shape} dtype {leaf.dtype} (fix the "
                    "T2R_SERVE_NATIVE_LAYERS override)"
                )
            q, scale = _channel_encode(leaf.astype(np.float32), regime)
            layout[flat_path] = {
                "shape": [int(d) for d in leaf.shape],
                "size": int(leaf.size),
                "granularity": GRAN_CHANNEL,
            }
            return {Q_KEY: torch.as_tensor(q), S_KEY: torch.from_numpy(scale)}
        if not (floating and leaf.size >= min_size):
            return torch.as_tensor(np.ascontiguousarray(leaf))
        size = int(leaf.size)
        leaf_block = _leaf_block(size, block)
        padded = -(-size // leaf_block) * leaf_block
        flat = leaf.astype(np.float32).reshape(-1)
        if padded != size:
            flat = np.pad(flat, (0, padded - size))
        payload = get_collective(regime, leaf_block).encode(torch.from_numpy(flat))
        layout[flat_path] = {
            "shape": [int(d) for d in leaf.shape],
            "size": size,
            "block": leaf_block,
            "padded": padded,
            "granularity": GRAN_BLOCK,
        }
        return {Q_KEY: payload["q"].contiguous(), S_KEY: payload["s"].contiguous()}

    tree = walk(variables, ())
    missing = native - seen
    if missing:
        raise ValueError(
            "native-eligible paths not found in the variables tree: "
            + ", ".join(sorted(missing))
            + " (fix the T2R_SERVE_NATIVE_LAYERS override)"
        )
    return tree, layout


def _dequantize_node(node: Mapping[str, torch.Tensor], meta: Mapping[str, Any],
                     regime: str, dtype=torch.float32) -> torch.Tensor:
    shape = tuple(int(d) for d in meta["shape"])
    if meta.get("granularity", GRAN_BLOCK) == GRAN_CHANNEL:
        return (node[Q_KEY].float() * node[S_KEY]).reshape(shape).to(dtype)
    flat = get_collective(regime, int(meta["block"])).decode(
        {"q": node[Q_KEY], "s": node[S_KEY]})
    return flat[: int(meta["size"])].reshape(shape).to(dtype)


def dequantize_tree(
    payload_tree: Any,
    layout: Mapping[str, Mapping[str, Any]],
    regime: str,
    dtype=torch.float32,
) -> Any:
    """Inverse of quantize_tree, in torch ops (so it traces into a
    program that takes the payload as an argument)."""

    def walk(node, path):
        if _is_payload_node(node):
            return _dequantize_node(node, layout["/".join(path)], regime, dtype)
        if isinstance(node, Mapping):
            return {key: walk(value, path + (key,)) for key, value in node.items()}
        return node

    return walk(payload_tree, ())


def payload_to(payload: Any, device: Union[str, torch.device]) -> Any:
    """The payload tree with every tensor on `device`."""
    if isinstance(payload, Mapping):
        return {key: payload_to(value, device) for key, value in payload.items()}
    return payload.to(device)


def save_payload(payload: Any, path: str) -> None:
    """Writes a payload tree (`torch.save`; read with `load_payload`)."""
    torch.save(payload_to(payload, "cpu"), path)


def load_payload(path: str, device: Union[str, torch.device] = "cpu") -> Any:
    return payload_to(torch.load(path, map_location="cpu", weights_only=True), device)


# -- eligibility ------------------------------------------------------------------


def default_native_eligibility(
    variables: Any,
    regime: str,
    min_size: int = DEFAULT_MIN_SIZE,
) -> Tuple[str, ...]:
    """Every 2-D dense and 3/4-D conv float '.../kernel' leaf of at least
    `min_size` elements and DEFAULT_MIN_NATIVE_ROWS contraction depth."""
    if regime not in NATIVE_DOT_REGIMES:
        return ()
    paths: List[str] = []
    for path, leaf in _flat_items(variables):
        leaf = _host(leaf)
        if (
            path.rsplit("/", 1)[-1] == "kernel"
            and leaf.ndim in (2, 3, 4)
            and np.issubdtype(leaf.dtype, np.floating)
            and leaf.size >= min_size
            and int(np.prod(leaf.shape[:-1])) >= DEFAULT_MIN_NATIVE_ROWS
        ):
            paths.append(path)
    return tuple(sorted(paths))


def resolve_native_eligibility(
    variables: Any,
    regime: str,
    min_size: int = DEFAULT_MIN_SIZE,
    override: Optional[str] = None,
) -> Tuple[str, ...]:
    """The eligibility map after the T2R_SERVE_NATIVE_LAYERS override
    (None reads the flag): 'auto'/unset the default map, 'none' nothing,
    else comma-separated fnmatch globs selecting among the default map."""
    if override is None:
        from tensor2robot_tpu_torch import flags

        override = flags.get_str("T2R_SERVE_NATIVE_LAYERS")
    candidates = default_native_eligibility(variables, regime, min_size)
    if override is None or override == "auto":
        return candidates
    if override == "none":
        return ()
    globs = [g.strip() for g in override.split(",") if g.strip()]
    return tuple(
        path for path in candidates if any(fnmatch.fnmatchcase(path, g) for g in globs)
    )


def attn_key(module_path: Sequence[str]) -> str:
    """The flat key of one attention module's contractions
    ('attn/<module path>'); static clips append ':q', ':k' or ':v'."""
    return "attn/" + "/".join(module_path)


def resolve_native_attention(override: Optional[str] = None):
    """Attention-head eligibility after T2R_SERVE_NATIVE_ATTN (None reads
    the flag): 'auto', () for 'none', or a tuple of fnmatch globs over the
    attention module's flat path. Flash, ring and Ulysses heads never
    lower: only the einsum path has the contraction override."""
    if override is None:
        from tensor2robot_tpu_torch import flags

        override = flags.get_str("T2R_SERVE_NATIVE_ATTN")
    if override is None or override == "auto":
        return "auto"
    if override == "none" or override == ():
        return ()
    if isinstance(override, (tuple, list)):
        return tuple(override)
    return tuple(g.strip() for g in override.split(",") if g.strip())


def _attention_eligible(spec, module_path: Sequence[str]) -> bool:
    if spec == "auto":
        return True
    flat = "/".join(module_path)
    return any(fnmatch.fnmatchcase(flat, g) for g in spec)


# -- native contractions -------------------------------------------------------


def _activation_scale(x: torch.Tensor, regime: str, a_clip: Optional[float],
                      axes: Tuple[int, ...] = (-1,)) -> torch.Tensor:
    """Dynamic max-abs over `axes` (a reduce in the program) when `a_clip`
    is None, else the static clip as a constant: no reduce at all."""
    if a_clip is None:
        dyn_max = x.abs().amax(dim=axes, keepdim=True)
        return torch.clamp_min(dyn_max, 1e-12) / _levels(regime)
    return torch.full((), max(float(a_clip), 1e-12) / _levels(regime),
                      dtype=torch.float32, device=x.device)


def _quantize_activation(x: torch.Tensor, a_scale, regime: str) -> torch.Tensor:
    if regime == "int8":
        return torch.clamp(torch.round(x / a_scale), -127, 127).to(torch.int8)
    dtype, fmax = _FP8_FORMATS[regime]
    return torch.clamp(x / a_scale, -fmax, fmax).to(dtype)


def _contract_operand(t: torch.Tensor) -> torch.Tensor:
    """The operand the device contracts: an e5m2 tensor on the card is
    upcast to f16 (exactly), since cuBLASLt multiplies no two e5m2
    matrices; every other operand as it is."""
    if t.dtype == torch.float8_e5m2 and t.device.type == "cuda":
        return t.to(torch.float16)
    return t


def _round_up(n, multiple: int):
    return (n + multiple - 1) // multiple * multiple


def _pad2d(t: torch.Tensor, rows, cols) -> torch.Tensor:
    """Zero-pads a 2-D tensor to [rows, cols] (fp8 through its bytes: zero
    is the all-zero bit pattern of both formats)."""
    pad = (0, cols - t.shape[1], 0, rows - t.shape[0])
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return F.pad(t.view(torch.uint8), pad).view(t.dtype)
    return F.pad(t, pad)


def quant_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] x [K, N] on low-precision operands, by operand dtype: int8
    -> int32 (`torch._int_mm`, exact), e4m3 or e5m2 -> f32
    (`torch._scaled_mm`, unit scales), f16 (the card's e5m2 route) -> f32
    (`torch.mm(..., out_dtype=float32)`). int8 appends 16 zero rows, and K
    and N are padded to multiples of 8 (int8) or 16 (fp8) on every device,
    as the card's library requires."""
    m, k = a.shape
    n = b.shape[1]
    if a.dtype == torch.int8:
        # 16 zero rows always: more than 16 rows whatever the batch, with
        # no guard on a dynamic batch dim.
        kp, np_ = _round_up(k, 8), _round_up(n, 8)
        b = _pad2d(b, kp, np_).t().contiguous().t()  # column-major: cuBLASLt's TN
        out = torch._int_mm(_pad2d(a, m + 16, kp), b)
        return out[:m, :n]
    if a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        kp, np_ = _round_up(k, 16), _round_up(n, 16)
        one = torch.ones((), dtype=torch.float32, device=a.device)
        b = _pad2d(b, kp, np_).t().contiguous().t()  # column-major
        out = torch._scaled_mm(_pad2d(a, m, kp), b, scale_a=one, scale_b=one,
                               out_dtype=torch.float32)
        return out[:, :n]
    if a.dtype == torch.float16:
        return torch.mm(a, b, out_dtype=torch.float32)
    raise TypeError(f"no low-precision contraction for {a.dtype} x {b.dtype}")


@torch.library.custom_op("t2r_torch::quant_bmm", mutates_args=())
def quant_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, M, K] x [N, K, P] on low-precision operands (quant_mm's rules),
    one 2-D contraction a slice: torch has no batched int8 or fp8 product,
    and one operator keeps the program's batch dim dynamic."""
    return torch.stack([quant_mm(a[i], b[i]) for i in range(a.shape[0])])


@quant_bmm.register_fake
def _quant_bmm_fake(a, b):
    dtype = torch.int32 if a.dtype == torch.int8 else torch.float32
    return a.new_empty((a.shape[0], a.shape[1], b.shape[2]), dtype=dtype)


def native_dot(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, regime: str,
               a_clip: Optional[float] = None) -> torch.Tensor:
    """One eligible dense contraction, natively low-precision: x [..., K]
    quantized per row (or against the static clip), contracted with the
    stored [K, N] kernel, both scales applied to the accumulator. Returns
    f32 [..., N]."""
    a_scale = _activation_scale(x, regime, a_clip)
    xq = _quantize_activation(x, a_scale, regime)
    acc = quant_mm(_contract_operand(xq.reshape(-1, x.shape[-1])), _contract_operand(q))
    acc = acc.float().reshape(tuple(x.shape[:-1]) + (q.shape[-1],))
    return acc * a_scale * scale


def _same_pads(size: int, kernel: int, dilation: int) -> Tuple[int, int]:
    total = dilation * (kernel - 1)
    return total // 2, total - total // 2


def native_conv(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, regime: str, *,
                stride=1, padding=0, dilation=1,
                a_clip: Optional[float] = None) -> torch.Tensor:
    """One eligible convolution, natively low-precision, in torch's layout:
    x [N, C, *spatial] (1-D or 2-D), q the stored kernel in the flax layout
    [*window, C, O] with one scale per output channel. The activation
    scale is per sample (or the static clip), constant along the whole
    window, so it moves to the accumulator exactly. `padding` is ints per
    spatial dim, 'valid' or 'same'. Returns f32 [N, O, *out_spatial]."""
    spatial = q.ndim - 2
    window = tuple(int(d) for d in q.shape[:spatial])
    stride = _conv_tuple(stride, spatial)
    dilation = _conv_tuple(dilation, spatial)
    a_scale = _activation_scale(x, regime, a_clip, axes=tuple(range(1, x.ndim)))
    xq = _quantize_activation(x, a_scale, regime)
    # im2col through f16, which holds every int8 and fp8 value exactly.
    carrier = xq.to(torch.float16)
    if isinstance(padding, str):
        if padding == "same":
            pads = [p for d in reversed(range(spatial))
                    for p in _same_pads(x.shape[2 + d], window[d], dilation[d])]
            carrier = F.pad(carrier, pads)
        padding = (0,) * spatial
    padding = _conv_tuple(padding, spatial)
    if spatial == 1:
        carrier = carrier.unsqueeze(2)
        window, stride, dilation, padding = ((1,) + window, (1,) + stride,
                                             (1,) + dilation, (0,) + padding)
    in_hw = carrier.shape[2:]
    out_hw = [(in_hw[d] + 2 * padding[d] - dilation[d] * (window[d] - 1) - 1)
              // stride[d] + 1 for d in range(2)]
    cols = F.unfold(carrier, window, dilation=dilation, padding=padding, stride=stride)
    depth = cols.shape[1]
    rows = cols.transpose(1, 2).reshape(-1, depth).to(xq.dtype)
    # [*window, C, O] -> [C, *window, O]: unfold's (channel, taps) order.
    kernel = q.permute((spatial,) + tuple(range(spatial)) + (spatial + 1,))
    acc = quant_mm(_contract_operand(rows),
                   _contract_operand(kernel.reshape(depth, q.shape[-1])))
    batch, out = x.shape[0], q.shape[-1]
    acc = acc.float().reshape(batch, -1, out).transpose(1, 2)
    acc = acc.reshape((batch, out) + tuple(out_hw[-spatial:]))
    return acc * a_scale * scale.reshape((1, out) + (1,) * spatial)


def _conv_tuple(value, n: int) -> Tuple[int, ...]:
    if value is None:
        return (1,) * n
    if isinstance(value, int):
        return (value,) * n
    return tuple(int(v) for v in value)


class _QuantAttentionContraction:
    """QK^T and PV on quantized operands: what an eligible attention
    module installs through ops/flash_attention's contraction override.
    The q/k/v scales are per row of the contraction (or a static clip),
    each constant along the summed axis; the softmax probs need no
    calibration (probs <= 1, so the static clip 1.0 bounds them)."""

    def __init__(self, regime: str, path_key: str, static_scales=None, fired=None):
        self.regime = regime
        self.path_key = path_key
        self._static = dict(static_scales or {})
        self._fired = fired

    def _clip(self, operand: str) -> Optional[float]:
        return self._static.get(f"{self.path_key}:{operand}")

    def qk(self, q, k, scale):
        regime = self.regime
        if self._fired is not None:
            self._fired.add(self.path_key)
        batch, seq_q, heads, depth = q.shape
        seq_k = k.shape[1]
        # [B, S, H, D] -> [B, H, S, D]: the scales are per (b, h, row).
        qh, kh = q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3)
        q_scale = _activation_scale(qh, regime, self._clip("q"))
        k_scale = _activation_scale(kh, regime, self._clip("k"))
        qq = _quantize_activation(qh, q_scale, regime)
        kq = _quantize_activation(kh, k_scale, regime)
        acc = quant_bmm(
            _contract_operand(qq.reshape(batch * heads, seq_q, depth)),
            _contract_operand(kq.transpose(2, 3).reshape(batch * heads, depth, seq_k)),
        ).float().reshape(batch, heads, seq_q, seq_k)
        acc = acc * q_scale  # [B, H, Q, 1] or a scalar
        acc = acc * (k_scale.transpose(2, 3) if k_scale.ndim else k_scale)
        return acc * scale

    def pv(self, probs, v):
        regime = self.regime
        batch, heads, seq_q, seq_k = probs.shape
        depth = v.shape[-1]
        p_scale = torch.full((), 1.0 / _levels(regime), dtype=torch.float32,
                             device=probs.device)
        pq = _quantize_activation(probs, p_scale, regime)
        vh = v.permute(0, 2, 1, 3)  # [B, H, K, D]
        v_clip = self._clip("v")
        v_scale = _activation_scale(vh, regime, v_clip, axes=(2,))  # [B, H, 1, D]
        vq = _quantize_activation(vh, v_scale, regime)
        acc = quant_bmm(
            _contract_operand(pq.reshape(batch * heads, seq_q, seq_k)),
            _contract_operand(vq.reshape(batch * heads, seq_k, depth)),
        ).float().reshape(batch, heads, seq_q, depth)
        acc = acc * p_scale
        acc = acc * v_scale
        return acc.permute(0, 2, 1, 3)  # [B, Q, H, D]


class _CaptureAttentionContraction:
    """The capture twin: records the |q|, |k|, |v| operand pools during the
    fp32 calibration run and computes the exact contractions."""

    def __init__(self, pool_fn, path_key: str):
        self._pool = pool_fn
        self.path_key = path_key

    def qk(self, q, k, scale):
        self._pool(f"{self.path_key}:q", q)
        self._pool(f"{self.path_key}:k", k)
        return torch.einsum("bqhd,bkhd->bhqk", q, k) * scale

    def pv(self, probs, v):
        self._pool(f"{self.path_key}:v", v)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attention_module_types() -> tuple:
    from tensor2robot_tpu_torch.layers.transformer import MultiHeadAttention

    return (MultiHeadAttention,)


_DENSE = (nn.Linear,)
_CONV = (nn.Conv1d, nn.Conv2d)


def _kernel_key(name: str) -> str:
    return "/".join(("params",) + (tuple(name.split(".")) if name else ()) + ("kernel",))


class _NativeDense:
    """Mixin of a lowered Linear: the stored operands, never the weight."""

    def forward(self, x):
        spec = self._t2r_native
        q, scale = spec.lowering.operands(spec.key)
        spec.fire()
        y = native_dot(x, q, scale, spec.regime, a_clip=spec.a_clip)
        return y if self.bias is None else y + self.bias


class _NativeConv:
    """Mixin of a lowered Conv1d/Conv2d: its own forward (any padding it
    applies first) runs unchanged, the contraction is the native one."""

    def _conv_forward(self, x, weight, bias):
        spec = self._t2r_native
        q, scale = spec.lowering.operands(spec.key)
        if x.ndim != q.ndim:  # unbatched: the dequantized kernel
            spatial = q.ndim - 2
            dims = (spatial + 1, spatial) + tuple(range(spatial))
            kernel = (q.float() * scale).permute(dims)
            return super()._conv_forward(x, kernel, bias)
        spec.fire()
        y = native_conv(x, q, scale, spec.regime, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        a_clip=spec.a_clip)
        return y if bias is None else y + bias.reshape((1, -1) + (1,) * (q.ndim - 2))


class _NativeAttention:
    """Mixin of a lowered attention module: its body runs inside the
    quantized contraction override (einsum heads only take it)."""

    def forward(self, *args, **kwargs):
        from tensor2robot_tpu_torch.ops import flash_attention as flash_lib

        with flash_lib.attention_contraction_override(self._t2r_native):
            return super().forward(*args, **kwargs)


_NATIVE_CLASSES: Dict[Tuple[type, type], type] = {}


def _swap_class(module: nn.Module, mixin: type) -> None:
    cls = type(module)
    native = _NATIVE_CLASSES.get((mixin, cls))
    if native is None:
        native = type(f"Native{cls.__name__}", (mixin, cls), {})
        _NATIVE_CLASSES[(mixin, cls)] = native
    module.__class__ = native


class _NativeSpec:
    def __init__(self, lowering, key, regime, a_clip, fired):
        self.lowering, self.key, self.regime = lowering, key, regime
        self.a_clip, self._fired = a_clip, fired

    def fire(self):
        if self._fired is not None:
            self._fired.add(self.key)


class NativeLowering:
    """The module swap of one serving network (`native_lowering`).

    `lowered` holds the flat kernel paths whose modules were swapped; the
    serving module leaves their f32 weights out of the call. `bind(payload)`
    is the context a call runs in: the swapped modules read their stored
    operands from that payload."""

    def __init__(self, network: nn.Module, layout: Mapping[str, Mapping[str, Any]],
                 regime: str, fired: Optional[set] = None,
                 static_scales: Optional[Mapping[str, float]] = None, attn=None):
        static = dict(static_scales or {})
        attn_spec = resolve_native_attention(attn) if attn != () else ()
        attn_types = _attention_module_types() if attn_spec != () else ()
        self.lowered: List[str] = []
        self._channel = sorted(
            path for path, meta in layout.items()
            if meta.get("granularity") == GRAN_CHANNEL)
        self._operands: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
        channel = set(self._channel)
        for name, module in network.named_modules():
            path = tuple(name.split(".")) if name else ()
            if attn_types and isinstance(module, attn_types):
                if _attention_eligible(attn_spec, path):
                    module._t2r_native = _QuantAttentionContraction(
                        regime, attn_key(path), static_scales=static, fired=fired)
                    _swap_class(module, _NativeAttention)
                continue
            key = _kernel_key(name)
            if key not in channel:
                continue
            if isinstance(module, _DENSE):
                mixin = _NativeDense
            elif isinstance(module, _CONV) and (
                    module.padding_mode == "zeros" and module.groups == 1):
                mixin = _NativeConv
            else:  # stays on the dequant path: the export lists it unlowered
                continue
            module._t2r_native = _NativeSpec(self, key, regime, static.get(key), fired)
            _swap_class(module, mixin)
            self.lowered.append(key)

    def operands(self, key: str) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._operands is None:
            raise RuntimeError("a lowered module ran outside NativeLowering.bind")
        return self._operands[key]

    @contextlib.contextmanager
    def bind(self, payload: Any):
        nodes = dict(_flat_items(payload))
        previous = self._operands
        self._operands = {key: (nodes[key][Q_KEY], nodes[key][S_KEY])
                          for key in self._channel}
        try:
            yield
        finally:
            self._operands = previous


def native_lowering(network: nn.Module, layout: Mapping[str, Mapping[str, Any]],
                    regime: str, fired: Optional[set] = None,
                    static_scales: Optional[Mapping[str, float]] = None,
                    attn=None) -> NativeLowering:
    """Lowers `network` (the serving module's own copy) in place: every
    Linear and Conv whose kernel is channel-quantized in `layout` becomes
    its native subclass (`native_dot` / `native_conv` on the stored
    operands, the static clip of `static_scales` where it has one), and
    every eligible attention module (`attn`, None reads
    T2R_SERVE_NATIVE_ATTN; () lowers none) runs its einsum contractions on
    quantized operands. `fired` collects the keys that actually lowered
    during a run: the export records claimed against fired."""
    return NativeLowering(network, layout, regime, fired=fired,
                          static_scales=static_scales, attn=attn)


# -- the audits of an exported program ---------------------------------------------

_DTYPE_NAMES = {
    torch.int8: "i8",
    torch.uint8: "u8",
    torch.int32: "i32",
    torch.float16: "f16",
    torch.bfloat16: "bf16",
    torch.float32: "f32",
    torch.float64: "f64",
    torch.float8_e4m3fn: "f8e4m3",
    torch.float8_e5m2: "f8e5m2",
}


def _program(program) -> torch.export.ExportedProgram:
    if isinstance(program, torch.export.ExportedProgram):
        return program
    if isinstance(program, (bytes, bytearray)):
        return torch.export.load(io.BytesIO(bytes(program)))
    return torch.export.load(os.fspath(program))


def _call_nodes(program):
    """The call_function nodes of a program's graph and of every subgraph
    (an autocast region is traced as one)."""
    for module in _program(program).graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                if node.op == "call_function":
                    yield node


def _contraction_targets() -> set:
    aten = torch.ops.aten
    return {
        aten.mm.default, aten.mm.dtype, aten.addmm.default, aten.bmm.default,
        aten.matmul.default, aten.linear.default, aten.einsum.default,
        aten.conv1d.default, aten.conv2d.default, aten.convolution.default,
        aten._int_mm.default, aten._scaled_mm.default,
        torch.ops.t2r_torch.quant_bmm.default,
    }


def _operand_dtype(arg) -> str:
    value = getattr(arg, "meta", {}).get("val")
    return _DTYPE_NAMES.get(getattr(value, "dtype", None), str(getattr(value, "dtype", "?")))


def audit_dot_dtypes(program) -> Dict[str, int]:
    """Counts the contraction nodes of an exported serving program (an
    ExportedProgram, its `.pt2` path or bytes) by operand element type
    ('i8' when both are int8, 'f32xi8' for mixed, ...), and 'total': the
    proof that a native regime's contractions stayed low-precision in the
    program, not just in the payload. Reads the graph, so a program traced
    on either device says what it contracts there."""
    targets = _contraction_targets()
    counts: Dict[str, int] = {}
    for node in _call_nodes(program):
        if node.target not in targets:
            continue
        if node.target == torch.ops.aten.einsum.default:
            operands = node.args[1][:2]
        else:
            operands = node.args[:2]
        lhs, rhs = (_operand_dtype(a) for a in operands)
        key = lhs if lhs == rhs else f"{lhs}x{rhs}"
        counts[key] = counts.get(key, 0) + 1
    counts["total"] = sum(counts.values())
    return counts


def _reduce_kinds() -> Dict[Any, str]:
    aten = torch.ops.aten
    return {
        aten.amax.default: "max", aten.max.dim: "max", aten.max.default: "max",
        aten.amin.default: "min", aten.min.dim: "min", aten.min.default: "min",
        aten.sum.dim_IntList: "add", aten.sum.default: "add",
        aten.prod.dim_int: "mul", aten.prod.default: "mul",
        aten.any.dim: "or", aten.any.default: "or", aten.any.dims: "or",
        aten.all.dim: "and", aten.all.default: "and", aten.all.dims: "and",
    }


def _count_reduce_kinds(program) -> Dict[str, int]:
    kinds = _reduce_kinds()
    counts: Dict[str, int] = {}
    for node in _call_nodes(program):
        kind = kinds.get(node.target)
        if kind is not None:
            counts[kind] = counts.get(kind, 0) + 1
    counts["total"] = sum(counts.values())
    return counts


def audit_quant_reduces(program, baseline=None) -> Dict[str, int]:
    """Counts the reduce nodes of an exported serving program by kind
    ('max', 'add', ...) and, against the f32 baseline program,
    `activation_quant_reduces` = its max reduces less the baseline's
    (clamped at 0): every dynamically quantized contraction adds one max
    reduce, so a statically calibrated program shows 0."""
    counts = _count_reduce_kinds(program)
    if baseline is not None:
        base = _count_reduce_kinds(baseline)
        counts["baseline_max"] = base.get("max", 0)
        counts["activation_quant_reduces"] = max(
            0, counts.get("max", 0) - base.get("max", 0))
    return counts


# -- activation calibration -----------------------------------------------------------


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """A conv input [N, C, *spatial] in the flax layout [N, *spatial, C]."""
    return x.permute((0,) + tuple(range(2, x.ndim)) + (1,))


@contextlib.contextmanager
def capture_activations(records: Dict[str, List[np.ndarray]], network: nn.Module):
    """Records per-layer |activation| pools while the fp32 forward of
    `network` runs eagerly inside the context: every Linear's and Conv's
    input under its flat kernel path ('params/.../kernel', in the flax
    layout, channels last), every attention module's q/k/v contraction
    operands under 'attn/<path>:q|k|v' (through the capture twin of the
    contraction override). Pools above CAPTURE_SAMPLES_PER_CALL are
    stride-subsampled with the exact max appended. Feed `records` to
    `calibrate_layer_activations`."""
    from tensor2robot_tpu_torch.ops import flash_attention as flash_lib

    def _pool(key: str, value) -> None:
        flat = np.abs(value.detach().float().cpu().numpy()).reshape(-1)
        if flat.size > CAPTURE_SAMPLES_PER_CALL:
            stride = -(-flat.size // CAPTURE_SAMPLES_PER_CALL)
            flat = np.append(flat[::stride], flat.max())
        records.setdefault(key, []).append(flat)

    attn_types = _attention_module_types()
    handles = []
    overrides: Dict[int, list] = {}
    try:
        for name, module in network.named_modules():
            if isinstance(module, _DENSE + _CONV):
                key = _kernel_key(name)
                conv = isinstance(module, _CONV)

                def pre(mod, args, key=key, conv=conv):
                    x = args[0]
                    _pool(key, _channels_last(x) if conv and x.ndim >= 3 else x)

                handles.append(module.register_forward_pre_hook(pre))
            elif isinstance(module, attn_types):
                impl = _CaptureAttentionContraction(
                    _pool, attn_key(tuple(name.split(".")) if name else ()))

                def enter(mod, args, impl=impl):
                    context = flash_lib.attention_contraction_override(impl)
                    context.__enter__()
                    overrides.setdefault(id(mod), []).append(context)

                def leave(mod, args, output):
                    overrides[id(mod)].pop().__exit__(None, None, None)

                handles.append(module.register_forward_pre_hook(enter))
                handles.append(module.register_forward_hook(leave))
        yield
    finally:
        for handle in handles:
            handle.remove()
        for stack in overrides.values():
            while stack:
                stack.pop().__exit__(None, None, None)


def calibrate_layer_activations(
    records: Mapping[str, Sequence[np.ndarray]],
    percentile: float = DEFAULT_CALIB_PERCENTILE,
) -> Dict[str, Dict[str, float]]:
    """{key: {'clip', 'observed_max', 'samples'}} from captured pools: the
    clip is the percentile of |x| (1.0 for an all-zero layer). NaN/Inf in
    a pool is a CalibrationError naming the layer."""
    calibration: Dict[str, Dict[str, float]] = {}
    for key in sorted(records):
        pool = np.concatenate(
            [np.asarray(chunk, np.float32).reshape(-1) for chunk in records[key]]
        )
        if pool.size == 0:
            continue
        if not np.all(np.isfinite(pool)):
            raise CalibrationError(
                f"activation capture for layer {key!r} contains NaN/Inf: "
                "the warmup corpus is poisoned; fix the corpus (or the "
                "fp32 forward) before exporting — a NaN-derived clip "
                "would silently zero the layer's quantization step."
            )
        clip = float(np.percentile(pool, percentile))
        calibration[key] = {
            "clip": clip if clip > 0 else 1.0,
            "observed_max": float(pool.max()),
            "samples": int(pool.size),
        }
    return calibration


def resolve_static_scales(
    layer_calibration: Mapping[str, Mapping[str, float]],
    overshoot_tol: float = DEFAULT_STATIC_OVERSHOOT,
) -> Tuple[Dict[str, float], Dict[str, float]]:
    """({key: clip}, {key: overshoot}): a layer whose observed max
    overshoots its clip by more than `overshoot_tol` keeps the dynamic
    quant and is recorded with its overshoot."""
    static: Dict[str, float] = {}
    demoted: Dict[str, float] = {}
    for key, entry in layer_calibration.items():
        clip = float(entry["clip"])
        observed = float(entry["observed_max"])
        overshoot = (observed - clip) / clip if clip > 0 else float("inf")
        if overshoot > overshoot_tol:
            demoted[key] = round(overshoot, 6)
        else:
            static[key] = clip
    return static, demoted


def calibrate_activations(
    batches: Sequence[Mapping[str, Any]],
    percentile: float = 99.9,
) -> Dict[str, float]:
    """{flat input key: clip}, the percentile of |x| over every warmup
    batch, for each FLOAT serving input (others get no entry)."""
    if not batches:
        raise CalibrationError("calibration needs at least one warmup batch")
    pools: Dict[str, List[np.ndarray]] = {}
    for batch in batches:
        for key, value in batch.items():
            value = _host(value)
            if not np.issubdtype(value.dtype, np.floating):
                continue
            if not np.all(np.isfinite(value)):
                raise CalibrationError(
                    f"warmup batch feature {key!r} contains NaN/Inf: the "
                    "calibration corpus is poisoned; fix the corpus "
                    "before exporting."
                )
            pools.setdefault(key, []).append(np.abs(value).reshape(-1))
    calibration = {}
    for key, chunks in pools.items():
        clip = float(np.percentile(np.concatenate(chunks), percentile))
        calibration[key] = clip if clip > 0 else 1.0
    return calibration


def fake_quant_activations(
    features: Mapping[str, torch.Tensor],
    calibration: Mapping[str, float],
    regime: str,
) -> Dict[str, torch.Tensor]:
    """Activation quantization at the serving inputs, in torch ops: int8
    fake-quantizes against the calibrated clip (255 levels), fp16 casts
    through fp16, fp8 scales the clip onto the format's range and
    round-trips through it. Keys without a clip pass through."""
    out = {}
    for key, x in features.items():
        clip = calibration.get(key)
        if clip is None:
            out[key] = x
            continue
        if regime == "fp16":
            out[key] = x.to(torch.float16).to(x.dtype)
        elif regime in _FP8_FORMATS:
            dtype, fmax = _FP8_FORMATS[regime]
            scale = torch.full((), clip / fmax, dtype=x.dtype, device=x.device)
            q = (torch.clamp(x, -clip, clip) / scale).to(dtype)
            out[key] = q.to(x.dtype) * scale
        else:
            step = torch.full((), clip / 127.0, dtype=x.dtype, device=x.device)
            out[key] = torch.round(torch.clamp(x, -clip, clip) / step) * step
    return out


# -- the parity gate ------------------------------------------------------------------


def measure_parity(
    fp32_outputs: Sequence[Mapping[str, Any]],
    quant_outputs: Sequence[Mapping[str, Any]],
) -> Dict[str, float]:
    """Max |quant - fp32| per flat output key over paired batches; a
    non-finite delta is +inf (so a NaN output fails the gate)."""
    divergence: Dict[str, float] = {}
    for ref, got in zip(fp32_outputs, quant_outputs):
        for key in ref:
            want, have = _host(ref[key]), _host(got[key])
            delta = float(np.max(np.abs(have - want))) if want.size else 0.0
            if not np.isfinite(delta):
                delta = float("inf")
            divergence[key] = max(divergence.get(key, 0.0), delta)
    return divergence


def check_parity(regime: str, divergence: Mapping[str, float], tolerance: float) -> None:
    """Raises QuantParityError when any output key exceeds the gate."""
    failing = {key: value for key, value in divergence.items() if value > tolerance}
    if failing:
        raise QuantParityError(
            f"serve-quant {regime} parity gate FAILED: max divergence vs the "
            f"fp32 forward over the warmup corpus exceeded the declared "
            f"tolerance {tolerance:g} on "
            + ", ".join(f"{key}={value:.3g}" for key, value in sorted(failing.items()))
            + ". The export was aborted; loosen the exporter's "
            "quant_parity_tol only with eval evidence, or drop the regime."
        )


# -- size accounting ------------------------------------------------------------------


def _leaves(tree: Any):
    if isinstance(tree, Mapping):
        for value in tree.values():
            yield from _leaves(value)
    else:
        yield tree


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return int(leaf.numel() * leaf.element_size())
    return int(np.asarray(leaf).nbytes)


def tree_nbytes(tree: Any) -> int:
    """Sum of array payload bytes in a (possibly quantized) tree."""
    return sum(_nbytes(leaf) for leaf in _leaves(tree))


def payload_nbytes(payload_tree: Any) -> Dict[str, int]:
    """{'values', 'scales', 'passthrough'} bytes of a payload tree."""
    counts = {"values": 0, "scales": 0, "passthrough": 0}

    def walk(node):
        if _is_payload_node(node):
            counts["values"] += _nbytes(node[Q_KEY])
            counts["scales"] += _nbytes(node[S_KEY])
            return
        if isinstance(node, Mapping):
            for value in node.values():
                walk(value)
            return
        counts["passthrough"] += _nbytes(node)

    walk(payload_tree)
    return counts
