"""Flash attention over [B, S, H, D]: the attention hot op of the port.

Three functions of one contract:

  * `reference_attention` — materialized-logits attention, the numerics
    oracle and the einsum path of MultiHeadAttention(use_flash=False).
  * `flash_attention_plain` — the flash recurrence in plain PyTorch: the
    same k-tile bounds, per-element masks, f32 online softmax with the
    finite cap -1e30, masked tiles contributing exactly 0 and the row sum
    floored at 1e-30, over the CUDA kernel's tiles (the kernel takes its
    softmax steps per 16-key chunk of a tile, which changes only the
    rounding). It is what `flash_attention` runs for CPU tensors and what
    the kernel is held against on the card.
  * `flash_fwd_kernel` — the wrapper of the hand-written CUDA kernel
    (csrc/flash_fwd.cu), the port of the Pallas `_flash_kernel` of
    tensor2robot_tpu/ops/flash_attention.py. It takes CUDA tensors only
    and counts its launches in `flash_fwd_kernel.launches`.

`flash_attention` dispatches on the tensors' device: CUDA tensors launch
the kernel (or raise), CPU tensors take the plain version. There is no
fallback from the kernel to anything else.

Positions are GLOBAL: q_offset/k_offset shift the causal mask so one call
can compute one (q-shard x k-shard) tile of a longer sequence. A query row
that sees no key comes out 0 from the flash versions but as a uniform
average from `reference_attention` (the JAX package behaves the same).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30

# Auto-dispatch crossover of MultiHeadAttention(use_flash=None): below this
# sequence length the einsum path is taken. The value is the JAX package's,
# set from TPU measurements; it is unmeasured on H100.
FLASH_AUTO_SEQ = 4096

# Tiles of the CUDA kernel (csrc/flash_fwd.cu: kBlockQ, BK); the plain
# version walks the same tiles so both skip the same k-tiles.
BLOCK_Q = 64
KERNEL_HEAD_DIMS = (32, 64, 128)

_SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def block_k_for(head_dim: int) -> int:
    """The kernel's k-tile length for a head dim (its register budget)."""
    return 64 if head_dim <= 64 else 32


def _check_window(window: Optional[int], causal: bool) -> None:
    """A window needs causal semantics, and window < 1 would mask
    everything (the reference path would then silently attend uniformly)."""
    if window is None:
        return
    if not causal:
        raise ValueError("window requires causal=True (causal sliding window)")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4:
        raise ValueError(f"Expected [B, S, H, D], got {tuple(q.shape)}")
    if k.shape != v.shape or k.ndim != 4:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must match as [B, S, H, D]"
        )
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} differ outside the "
            "sequence dim"
        )
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("attention over an empty sequence")


def k_block_bounds(
    q0: int, rows: int, block_k: int, num_kb: int, k_off: int,
    causal: bool, window: Optional[int],
) -> Tuple[int, int]:
    """[j_lo, j_hi) over the k-tiles visible to the q-tile whose `rows`
    rows start at GLOBAL position q0. Exact: causal keeps tiles whose first
    key is <= the tile's last query; the window keeps tiles whose last key
    is > q0 - W (floor division on possibly negative numerators)."""
    j_lo, j_hi = 0, num_kb
    if causal:
        j_hi = max(0, min(num_kb, (q0 + rows - 1 - k_off) // block_k + 1))
    if window is not None:
        j_lo = max(0, (q0 - window + 1 - k_off) // block_k)
    return j_lo, j_hi


def _visible(q_pos, k_pos, window):
    visible = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        visible = visible & (q_pos[:, None] - k_pos[None, :] < window)
    return visible


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Materialized-logits attention over [B, S, H, D] in the input dtype.
    window=W restricts each query to the last W keys (q-W < k <= q);
    requires causal=True. Fully masked rows normalize against the finite
    cap (uniform weights) instead of NaN-ing."""
    _check_window(window, causal)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(~_visible(q_pos, k_pos, window), _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The kernel's recurrence in plain PyTorch (any device): q-tiles of
    BLOCK_Q rows, only the visible k-tiles of block_k_for(D) keys, f32
    online softmax, output normalized and cast to q's dtype."""
    _check_window(window, causal)
    _check_shapes(q, k, v)
    _, s_q, _, dim = q.shape
    s_k = k.shape[1]
    scale = scale if scale is not None else dim ** -0.5
    block_k = block_k_for(dim)
    num_kb = -(-s_k // block_k)
    # [B, H, S, D] f32 views for batched matmuls over (b, h).
    qf = (q.float() * scale).transpose(1, 2)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    out = torch.empty(qf.shape, dtype=torch.float32, device=q.device)
    for r0 in range(0, s_q, BLOCK_Q):
        rows = min(BLOCK_Q, s_q - r0)
        q_blk = qf[:, :, r0:r0 + rows]
        q_pos = q_offset + r0 + torch.arange(rows, device=q.device)
        j_lo, j_hi = k_block_bounds(
            q_offset + r0, rows, block_k, num_kb, k_offset, causal, window
        )
        o_acc = torch.zeros(q_blk.shape, dtype=torch.float32, device=q.device)
        l_acc = torch.zeros(q_blk.shape[:-1] + (1,), device=q.device)
        m_acc = torch.full_like(l_acc, _NEG_INF)
        for j in range(j_lo, j_hi):
            c0 = j * block_k
            c1 = min(c0 + block_k, s_k)
            s = q_blk @ kf[:, :, c0:c1].transpose(-1, -2)
            if causal:
                k_pos = k_offset + torch.arange(c0, c1, device=q.device)
                s = s.masked_fill(~_visible(q_pos, k_pos, window), _NEG_INF)
            m_new = torch.maximum(m_acc, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m_acc - m_new)
            p = torch.exp(s - m_new).masked_fill(m_new == _NEG_INF, 0.0)
            l_acc = l_acc * alpha + p.sum(dim=-1, keepdim=True)
            o_acc = o_acc * alpha + p @ vf[:, :, c0:c1]
            m_acc = m_new
        out[:, :, r0:r0 + rows] = o_acc / l_acc.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


# -- the CUDA kernel ----------------------------------------------------------


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
            "flash kernel is built from csrc/flash_fwd.cu at first use"
        )
    return nvcc


def build_library(head_dim: int) -> Path:
    """Compiles csrc/flash_fwd.cu for sm_90a and one head dim into
    build/kernels/ (once per source and flag set; the file name carries
    their hash) and returns the shared library's path. The compiler's
    register/spill report is kept beside it as <name>.log."""
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash kernel head dim must be one of {KERNEL_HEAD_DIMS}, "
            f"got {head_dim}"
        )
    flags = _NVCC_FLAGS + (f"-DT2R_HEAD_DIM={head_dim}",)
    digest = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    target = _BUILD_DIR / f"flash_fwd_d{head_dim}-{digest}.so"
    if target.exists():
        return target
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_find_nvcc(), *flags, "-o", str(tmp), str(_SOURCE)]
    result = subprocess.run(cmd, capture_output=True, text=True, check=False)
    target.with_suffix(".log").write_text(result.stdout + result.stderr)
    if result.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({result.returncode}) building {_SOURCE} for head "
            f"dim {head_dim}:\n{result.stderr[-4000:]}"
        )
    os.replace(tmp, target)
    return target


_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = (
    [_PTR] * 4 + [_INT] * 6 + [_LL] * 12 + [ctypes.c_float] + [_INT] * 4 + [_PTR]
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class FlashForwardKernel:
    """Wrapper of the CUDA flash forward. Builds and loads the library of
    a head dim at its first call, validates its inputs, launches on the current stream and
    raises on any launch error. `launches` counts successful launches."""

    def __init__(self):
        self.launches = 0
        self._fns = {}
        self._lock = threading.Lock()

    def _function(self, head_dim: int):
        with self._lock:
            fn = self._fns.get(head_dim)
            if fn is None:
                fn = ctypes.CDLL(str(build_library(head_dim))).t2r_flash_fwd
                fn.argtypes = _ARGTYPES
                fn.restype = ctypes.c_int
                self._fns[head_dim] = fn
            return fn

    def __call__(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        causal: bool = False,
        scale: Optional[float] = None,
        q_offset: int = 0,
        k_offset: int = 0,
        window: Optional[int] = None,
    ) -> torch.Tensor:
        _check_window(window, causal)
        _check_shapes(q, k, v)
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.device.type != "cuda" or t.device != q.device:
                raise ValueError(
                    f"{name} must lie on q's CUDA device, got {t.device}"
                )
            if t.dtype != q.dtype:
                raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if q.dtype not in _DTYPE_CODES:
            raise ValueError(f"flash kernel takes float32/bfloat16, got {q.dtype}")
        batch, s_q, heads, dim = q.shape
        fn = self._function(dim)
        if batch > 65535 or heads > 65535:
            raise ValueError(f"grid limit: batch {batch}, heads {heads} > 65535")
        q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
        scale = scale if scale is not None else dim ** -0.5
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            batch, heads, s_q, k.shape[1], dim, _DTYPE_CODES[q.dtype],
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            float(scale), int(causal), int(window or 0),
            int(q_offset), int(k_offset), stream,
        )
        if err != 0:
            raise RuntimeError(f"flash kernel launch failed: cudaError {err}")
        self.launches += 1
        return out


flash_fwd_kernel = FlashForwardKernel()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention over [B, S, H, D]: the CUDA kernel for CUDA tensors,
    the plain recurrence for CPU tensors."""
    if q.device.type == "cuda":
        return flash_fwd_kernel(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            k_offset=k_offset, window=window,
        )
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    return flash_attention_plain(
        q, k, v, causal=causal, scale=scale, q_offset=q_offset,
        k_offset=k_offset, window=window,
    )
