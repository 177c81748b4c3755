"""Flash attention over [B, S, H, D]: the attention hot op of the port.

Functions of one contract, each kernel beside its plain PyTorch version:

  * `reference_attention` — materialized-logits attention, the numerics
    oracle and the einsum path of MultiHeadAttention(use_flash=False);
    its two contractions are the override point of the low-precision
    serving exports (`attention_contraction_override`).
  * `flash_attention_plain` / `flash_fwd_kernel` (B2, csrc/flash_fwd.cu,
    port of the Pallas `_flash_kernel`) — the normalized forward: the same
    k-tile bounds, per-element masks, f32 online softmax with the finite
    cap -1e30, masked tiles contributing exactly 0 and the row sum floored
    at 1e-30. The forward taken when no gradient is asked for.
  * `flash_attention_tile_plain` / `flash_tile_kernel` (B1, csrc/
    flash_fwd.cu, port of `_flash_tile_kernel`) — the same recurrence
    returning the UNNORMALIZED f32 output and the row stats l, m.
  * `flash_attention_bwd_plain` / `flash_bwd_dq_kernel` (B3) and
    `flash_bwd_dkv_kernel` (B4) (csrc/flash_bwd.cu, ports of
    `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`) — dq, dk, dv in
    f32 from the forward's lse = m + log(l) and delta = rowsum(dO * O),
    deterministic (no atomics).

All four kernels run their products on the tensor cores in split f32
(3xTF32 mma.sync, csrc/flash_mma.cuh), which keeps f32 accuracy. The plain
versions walk the kernels' own tiles (BLOCK_Q rows or keys per thread
block, `block_k_for(D)` per staged tile), so a kernel and its plain version
differ by rounding only; the forward kernels take their softmax steps per
32-key chunk of a tile, and every product as three TF32 products, which
changes only the rounding too.

`flash_attention` dispatches: with grad enabled and any of q/k/v requiring
grad it runs `FlashAttentionFunction` (B1 forward, B3+B4 backward, as the
JAX package's custom VJP); otherwise the normalized forward, through the
operator `t2r_torch::flash_fwd` (`flash_fwd_op`, with a fake for tracing),
so a `torch.export` program records B2 as one node on either device. Each
step launches its CUDA kernel for CUDA tensors (or raises) and takes its
plain version for CPU tensors. There is no fallback from a kernel to
anything else.

Positions are GLOBAL: q_offset/k_offset shift the causal mask so one call
can compute one (q-shard x k-shard) tile of a longer sequence. A query row
that sees no key comes out 0 from the flash versions, with a zero q
gradient, but as a uniform average from `reference_attention` (the JAX
package behaves the same).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

_NEG_INF = -1e30

# The contraction override (export/serve_quant.py's attention lowering):
# inside `attention_contraction_override(impl)`, `reference_attention`
# takes its logits from `impl.qk(q, k, scale)` and its mixed output from
# `impl.pv(probs, v)`; masks, softmax and dtypes are unchanged. Only the
# einsum path consults it: the flash path suppresses it (the kernel B2 and
# its plain version have no materialized contraction to swap), as do
# Ulysses' einsum tiles, so a flash-configured head computes what the
# kernel computes, in f32, on every host.
_CONTRACTION_OVERRIDE: contextvars.ContextVar = contextvars.ContextVar(
    "t2r_torch_attention_contraction_override", default=None
)


@contextlib.contextmanager
def attention_contraction_override(impl):
    """Installs `impl` (with .qk(q, k, scale) and .pv(probs, v)) as
    reference_attention's contractions for the context; None suppresses
    an outer one."""
    token = _CONTRACTION_OVERRIDE.set(impl)
    try:
        yield
    finally:
        _CONTRACTION_OVERRIDE.reset(token)


# Auto-dispatch crossover of MultiHeadAttention(use_flash=None): below this
# sequence length the einsum path is taken. The value is the JAX package's,
# set from TPU measurements; it is unmeasured on H100.
FLASH_AUTO_SEQ = 4096

# Rows (forward, dq) or keys (dkv) owned by one thread block of the CUDA
# kernels (csrc/flash_common.cuh: kBlockRows); the plain versions walk the
# same tiles so both skip the same ones.
BLOCK_Q = 64
# The head dims the kernels are built for; the wrappers zero-pad any other
# head dim up to MAX_HEAD_DIM to the next of them (kernel_head_dim).
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
MAX_HEAD_DIM = KERNEL_HEAD_DIMS[-1]

_CSRC = Path(__file__).resolve().parent / "csrc"
# One shared library per source and head dim.
KERNEL_SOURCES = ("flash_fwd", "flash_bwd")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def block_k_for(head_dim: int) -> int:
    """Length of a staged tile at a head dim (csrc/flash_common.cuh:
    staged_tile): the forward's and dq's k-tile, dkv's q-tile. A head dim
    and the built size it is padded to (kernel_head_dim) give the same
    length, so a padded launch walks the plain version's tiles."""
    return 64 if head_dim <= 64 else 32


def kernel_head_dim(head_dim: int) -> int:
    """The built head dim a head dim runs at: the smallest of
    KERNEL_HEAD_DIMS that holds it. Raises ValueError above MAX_HEAD_DIM."""
    for size in KERNEL_HEAD_DIMS:
        if 1 <= head_dim <= size:
            return size
    raise ValueError(
        f"flash attention takes head dims 1..{MAX_HEAD_DIM} (the kernels' "
        f"largest built size), got {head_dim}"
    )


def call_padded(fn, q, k, v, *rest, scale=None, **kwargs):
    """Calls `fn(q, k, v, *rest, scale=..., **kwargs)` at the built head
    dim: q, k, v and a dout among `rest` (any [B, S, H, D] tensor) are
    zero-padded along D to kernel_head_dim(D), and D columns of each
    [B, S, H, D] output are sliced back off. `scale` stays 1/sqrt(D) of
    the true D. Zero columns add nothing to q k^T, give zero output
    columns, and leave delta = rowsum(dO * O) and the row stats (lse,
    l, m; [B, H, S]) as they are. `fn` is a kernel or, in a test, its
    plain version."""
    dim = q.shape[-1]
    scale = dim ** -0.5 if scale is None else scale
    width = kernel_head_dim(dim)
    if width == dim:
        return fn(q, k, v, *rest, scale=scale, **kwargs)

    def pad(t):
        if t.ndim != 4:
            return t
        return torch.nn.functional.pad(t, (0, width - dim))

    out = fn(*(pad(t) for t in (q, k, v, *rest)), scale=scale, **kwargs)
    if isinstance(out, tuple):
        return tuple(t[..., :dim] if t.ndim == 4 else t for t in out)
    return out[..., :dim]


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


def _check_bwd_shapes(q, k, v, dout, lse, delta) -> None:
    _check_shapes(q, k, v)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must match q {tuple(q.shape)}")
    stats = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != stats:
            raise ValueError(f"{name} must be [B, H, Sq] = {stats}, got {tuple(t.shape)}")


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


def q_block_bounds(
    k0: int, cols: int, block_q: int, num_qb: int, q_off: int,
    causal: bool, window: Optional[int],
) -> Tuple[int, int]:
    """[i_lo, i_hi) over the q-tiles visible to the k-tile whose `cols`
    keys start at GLOBAL position k0: k_block_bounds transposed (the JAX
    dkv kernel's bounds). Exact: causal keeps q-tiles whose last query is
    >= k0; the window keeps q-tiles whose first query is <= the tile's
    last key + W - 1."""
    i_lo, i_hi = 0, num_qb
    if causal:
        i_lo = max(0, (k0 - q_off) // block_q)
    if window is not None:
        i_hi = max(
            0, min(num_qb, (k0 + cols - 1 + window - 1 - q_off) // block_q + 1)
        )
    return i_lo, i_hi


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
    q_offset: Union[int, torch.Tensor] = 0,
    k_offset: Union[int, torch.Tensor] = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Materialized-logits attention over [B, S, H, D] in the input dtype.
    window=W restricts each query to the last W keys (q-W < k <= q);
    requires causal=True. Fully masked rows normalize against the finite
    cap (uniform weights) instead of NaN-ing. The offsets may be 0-dim
    device tensors (a decode step's position, kept off the host so the
    step can be graph-captured or traced)."""
    _check_window(window, causal)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    override = _CONTRACTION_OVERRIDE.get()
    if override is not None:
        logits = override.qk(q, k, scale)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(~_visible(q_pos, k_pos, window), _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if override is not None:
        return override.pv(probs, v).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


# -- plain versions -------------------------------------------------------------


def _forward_plain(q, k, v, causal, scale, q_offset, k_offset, window):
    """The forward recurrence over the kernel's tiles. Returns the raw
    accumulators (o [B, H, Sq, D], l [B, H, Sq], m [B, H, Sq]), all f32."""
    _check_window(window, causal)
    _check_shapes(q, k, v)
    s_q, dim = q.shape[1], q.shape[3]
    s_k = k.shape[1]
    block_k = block_k_for(dim)
    num_kb = -(-s_k // block_k)
    # [B, H, S, D] f32 views for batched matmuls over (b, h).
    qf = (q.float() * scale).transpose(1, 2)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    o = torch.empty(qf.shape, dtype=torch.float32, device=q.device)
    l = torch.empty(qf.shape[:-1], dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
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
        o[:, :, r0:r0 + rows] = o_acc
        l[:, :, r0:r0 + rows] = l_acc[..., 0]
        m[:, :, r0:r0 + rows] = m_acc[..., 0]
    return o, l, m


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
    """B2's plain version (any device): the recurrence over the kernel's
    tiles, output normalized with l floored at 1e-30 and cast to q's
    dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    o, l, _ = _forward_plain(q, k, v, causal, scale, q_offset, k_offset, window)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention_tile_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B1's plain version (any device): (o [B, Sq, H, D] unnormalized,
    l [B, H, Sq], m [B, H, Sq]), all f32 — the JAX flash_attention_tile
    contract."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    o, l, m = _forward_plain(q, k, v, causal, scale, q_offset, k_offset, window)
    return o.transpose(1, 2), l, m


def flash_attention_bwd_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in contiguous [B, H, Sq] f32: the O(S*D)
    precompute both backward kernels read (plain torch, as the JAX package
    leaves it outside Pallas)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


class _BwdRecompute:
    """The backward's shared recompute (the JAX `_bwd_tile`) over f32
    [B, H, S, D] views: (p, ds) of one (q rows x keys) tile from the saved
    row stats. Masking selects, so a masked logit never turns into
    inf * 0."""

    def __init__(self, q, k, v, dout, lse, delta, causal, scale, q_offset,
                 k_offset, window):
        _check_window(window, causal)
        _check_bwd_shapes(q, k, v, dout, lse, delta)
        self.scale = scale if scale is not None else q.shape[-1] ** -0.5
        self.qf = (q.float() * self.scale).transpose(1, 2)
        self.kf = k.float().transpose(1, 2)
        self.vf = v.float().transpose(1, 2)
        self.dof = dout.float().transpose(1, 2)
        self.lse = lse.float()[..., None]
        self.delta = delta.float()[..., None]
        self.causal, self.window = causal, window
        self.q_offset, self.k_offset = q_offset, k_offset
        self.s_q, self.s_k = q.shape[1], k.shape[1]
        self.tile = block_k_for(q.shape[-1])

    def __call__(self, r0, r1, c0, c1):
        s = self.qf[:, :, r0:r1] @ self.kf[:, :, c0:c1].transpose(-1, -2)
        p = torch.exp(s - self.lse[:, :, r0:r1])
        if self.causal:
            device = s.device
            q_pos = self.q_offset + torch.arange(r0, r1, device=device)
            k_pos = self.k_offset + torch.arange(c0, c1, device=device)
            p = torch.where(_visible(q_pos, k_pos, self.window), p, 0.0)
        dp = self.dof[:, :, r0:r1] @ self.vf[:, :, c0:c1].transpose(-1, -2)
        return p, p * (dp - self.delta[:, :, r0:r1])


def flash_attention_bwd_dq_plain(
    q, k, v, dout, lse, delta, causal=False, scale=None, q_offset=0,
    k_offset=0, window=None,
) -> torch.Tensor:
    """B3's plain version (any device): dq f32 [B, Sq, H, D], walking
    q-tiles of BLOCK_Q rows over their visible k-tiles of block_k_for(D)
    keys; scaled once at the end."""
    r = _BwdRecompute(q, k, v, dout, lse, delta, causal, scale, q_offset,
                      k_offset, window)
    dq = torch.zeros(r.qf.shape, dtype=torch.float32, device=q.device)
    num_kb = -(-r.s_k // r.tile)
    for r0 in range(0, r.s_q, BLOCK_Q):
        rows = min(BLOCK_Q, r.s_q - r0)
        j_lo, j_hi = k_block_bounds(
            q_offset + r0, rows, r.tile, num_kb, k_offset, causal, window
        )
        for j in range(j_lo, j_hi):
            c0, c1 = j * r.tile, min((j + 1) * r.tile, r.s_k)
            _, ds = r(r0, r0 + rows, c0, c1)
            dq[:, :, r0:r0 + rows] += ds @ r.kf[:, :, c0:c1]
    return (dq * r.scale).transpose(1, 2)


def flash_attention_bwd_dkv_plain(
    q, k, v, dout, lse, delta, causal=False, scale=None, q_offset=0,
    k_offset=0, window=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4's plain version (any device): (dk, dv) f32 [B, Sk, H, D],
    walking k-tiles of BLOCK_Q keys over their visible q-tiles of
    block_k_for(D) rows (q_block_bounds)."""
    r = _BwdRecompute(q, k, v, dout, lse, delta, causal, scale, q_offset,
                      k_offset, window)
    dk = torch.zeros(r.kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    num_qb = -(-r.s_q // r.tile)
    for c0 in range(0, r.s_k, BLOCK_Q):
        cols = min(BLOCK_Q, r.s_k - c0)
        i_lo, i_hi = q_block_bounds(
            k_offset + c0, cols, r.tile, num_qb, q_offset, causal, window
        )
        for i in range(i_lo, i_hi):
            r0, r1 = i * r.tile, min((i + 1) * r.tile, r.s_q)
            p, ds = r(r0, r1, c0, c0 + cols)
            dv[:, :, c0:c0 + cols] += p.transpose(-1, -2) @ r.dof[:, :, r0:r1]
            # q is pre-scaled: dk carries its single factor of scale.
            dk[:, :, c0:c0 + cols] += ds.transpose(-1, -2) @ r.qf[:, :, r0:r1]
    return dk.transpose(1, 2), dv.transpose(1, 2)


def flash_attention_bwd_plain(
    q, k, v, dout, lse, delta, causal=False, scale=None, q_offset=0,
    k_offset=0, window=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B3 and B4's plain versions together: (dq, dk, dv), f32."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset, window=window)
    dq = flash_attention_bwd_dq_plain(q, k, v, dout, lse, delta, **kw)
    return (dq,) + flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, **kw)


# -- the CUDA kernels -----------------------------------------------------------


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
            "flash kernels are built from csrc/ at first use"
        )
    return nvcc


def _flags(head_dim: int) -> Tuple[str, ...]:
    return _NVCC_FLAGS + (f"-DT2R_HEAD_DIM={head_dim}",)


def library_path(head_dim: int, source: str = "flash_fwd") -> Path:
    """Where build_library puts csrc/<source>.cu built for one head dim:
    the file name carries a hash of the source, every header under csrc/
    (by name and content) and the flags, so any change rebuilds."""
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash kernel head dim must be one of {KERNEL_HEAD_DIMS}, "
            f"got {head_dim}"
        )
    if source not in KERNEL_SOURCES:
        raise ValueError(f"unknown kernel source {source!r}")
    digest = hashlib.sha256((_CSRC / f"{source}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(_flags(head_dim)).encode())
    return _BUILD_DIR / f"{source}_d{head_dim}-{digest.hexdigest()[:16]}.so"


def build_library(head_dim: int, source: str = "flash_fwd") -> Path:
    """Compiles csrc/<source>.cu for sm_90a and one head dim into
    build/kernels/ (once per library_path) and returns the shared
    library's path. The compiler's register/spill report is kept beside
    it as <name>.log."""
    target = library_path(head_dim, source)
    path = _CSRC / f"{source}.cu"
    flags = _flags(head_dim)
    if target.exists():
        return target
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_find_nvcc(), *flags, "-o", str(tmp), str(path)]
    result = subprocess.run(cmd, capture_output=True, text=True, check=False)
    target.with_suffix(".log").write_text(result.stdout + result.stderr)
    if result.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({result.returncode}) building {path} for head "
            f"dim {head_dim}:\n{result.stderr[-4000:]}"
        )
    os.replace(tmp, target)
    return target


_PTR, _LL, _INT, _FLOAT = (
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
)
# Every entry point ends in (scale, causal, window, q_offset, k_offset,
# stream) after its pointers, (batch, heads, sq, sk, head_dim, dtype) and
# three strides per strided tensor.
_TAIL = [_FLOAT] + [_INT] * 4 + [_PTR]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LOAD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _library(head_dim: int, source: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(head_dim, source)))


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    return tuple(t.stride()[:3])


class _CudaKernel:
    """A C entry point of a kernel library, bound with ctypes. Builds and
    loads the library of a head dim at its first call, validates inputs,
    launches on the current stream and raises on any launch error.
    `launches` counts successful launches."""

    source = ""
    symbol = ""
    pointers = 0
    strided = 0

    def __init__(self):
        self.launches = 0
        self._fns = {}

    def _function(self, head_dim: int):
        with _LOAD_LOCK:
            fn = self._fns.get(head_dim)
            if fn is None:
                fn = getattr(_library(head_dim, self.source), self.symbol)
                fn.argtypes = (
                    [_PTR] * self.pointers + [_INT] * 6
                    + [_LL] * (3 * self.strided) + _TAIL
                )
                fn.restype = ctypes.c_int
                self._fns[head_dim] = fn
            return fn

    @staticmethod
    def _inputs(named, stats=()):
        """Checks q/k/v(/dout) and f32 row stats for a launch; returns the
        tensors with a contiguous last dim (stats fully contiguous)."""
        q = named[0][1]
        for name, t in named + list(stats):
            if t.device.type != "cuda" or t.device != q.device:
                raise ValueError(
                    f"{name} must lie on q's CUDA device, got {t.device}"
                )
        for name, t in named:
            if t.dtype != q.dtype:
                raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if q.dtype not in _DTYPE_CODES:
            raise ValueError(f"flash kernel takes float32/bfloat16, got {q.dtype}")
        for name, t in stats:
            if t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32, got {t.dtype}")
        if q.shape[0] > 65535 or q.shape[2] > 65535:
            raise ValueError(
                f"grid limit: batch {q.shape[0]}, heads {q.shape[2]} > 65535"
            )
        tensors = [t if t.stride(-1) == 1 else t.contiguous() for _, t in named]
        return tensors + [t.contiguous() for _, t in stats]

    def _launch(self, q, k, *args):
        batch, s_q, heads, dim = q.shape
        fn = self._function(dim)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args[:self.pointers], batch, heads, s_q, k.shape[1], dim,
                 _DTYPE_CODES[q.dtype], *args[self.pointers:], stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: cudaError {err}"
            )
        self.launches += 1


class FlashForwardKernel(_CudaKernel):
    """B2: the normalized forward (t2r_flash_fwd). Refuses inputs that
    require grad while grad is enabled: its output has no grad_fn, so it
    would cut attention out of the gradient (flash_attention routes such
    inputs through FlashAttentionFunction)."""

    source, symbol, pointers, strided = "flash_fwd", "t2r_flash_fwd", 4, 4

    def __call__(self, q, k, v, causal=False, scale=None, q_offset=0,
                 k_offset=0, window=None) -> torch.Tensor:
        if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)
        ):
            raise RuntimeError(
                "flash_fwd_kernel gives no gradient; inputs that require "
                "grad go through flash_attention (FlashAttentionFunction)"
            )
        _check_window(window, causal)
        _check_shapes(q, k, v)
        return call_padded(self._run, q, k, v, scale=scale, causal=causal,
                           q_offset=q_offset, k_offset=k_offset, window=window)

    def _run(self, q, k, v, scale, causal, q_offset, k_offset, window):
        q, k, v = self._inputs([("q", q), ("k", k), ("v", v)])
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        self._launch(
            q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            float(scale), int(causal), int(window or 0), int(q_offset),
            int(k_offset),
        )
        return out


class FlashTileKernel(_CudaKernel):
    """B1: the unnormalized forward with row stats (t2r_flash_fwd_tile).
    Returns (o f32 [B, Sq, H, D], l f32 [B, H, Sq], m f32 [B, H, Sq])."""

    source, symbol, pointers, strided = "flash_fwd", "t2r_flash_fwd_tile", 6, 4

    def __call__(self, q, k, v, causal=False, scale=None, q_offset=0,
                 k_offset=0, window=None):
        _check_window(window, causal)
        _check_shapes(q, k, v)
        return call_padded(self._run, q, k, v, scale=scale, causal=causal,
                           q_offset=q_offset, k_offset=k_offset, window=window)

    def _run(self, q, k, v, scale, causal, q_offset, k_offset, window):
        q, k, v = self._inputs([("q", q), ("k", k), ("v", v)])
        batch, s_q, heads, _ = q.shape
        o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        l = torch.empty((batch, heads, s_q), dtype=torch.float32, device=q.device)
        m = torch.empty_like(l)
        self._launch(
            q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            l.data_ptr(), m.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(o),
            float(scale), int(causal), int(window or 0), int(q_offset),
            int(k_offset),
        )
        return o, l, m


class FlashBwdDqKernel(_CudaKernel):
    """B3: dq in f32 [B, Sq, H, D] (t2r_flash_bwd_dq)."""

    source, symbol, pointers, strided = "flash_bwd", "t2r_flash_bwd_dq", 7, 5

    def __call__(self, q, k, v, dout, lse, delta, causal=False, scale=None,
                 q_offset=0, k_offset=0, window=None) -> torch.Tensor:
        _check_window(window, causal)
        _check_bwd_shapes(q, k, v, dout, lse, delta)
        return call_padded(self._run, q, k, v, dout, lse, delta, scale=scale,
                           causal=causal, q_offset=q_offset,
                           k_offset=k_offset, window=window)

    def _run(self, q, k, v, dout, lse, delta, scale, causal, q_offset,
             k_offset, window):
        q, k, v, dout, lse, delta = self._inputs(
            [("q", q), ("k", k), ("v", v), ("dout", dout)],
            [("lse", lse), ("delta", delta)],
        )
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        self._launch(
            q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(dout),
            *_strides(dq),
            float(scale), int(causal), int(window or 0), int(q_offset),
            int(k_offset),
        )
        return dq


class FlashBwdDkvKernel(_CudaKernel):
    """B4: (dk, dv) in f32 [B, Sk, H, D] (t2r_flash_bwd_dkv)."""

    source, symbol, pointers, strided = "flash_bwd", "t2r_flash_bwd_dkv", 8, 6

    def __call__(self, q, k, v, dout, lse, delta, causal=False, scale=None,
                 q_offset=0, k_offset=0, window=None):
        _check_window(window, causal)
        _check_bwd_shapes(q, k, v, dout, lse, delta)
        return call_padded(self._run, q, k, v, dout, lse, delta, scale=scale,
                           causal=causal, q_offset=q_offset,
                           k_offset=k_offset, window=window)

    def _run(self, q, k, v, dout, lse, delta, scale, causal, q_offset,
             k_offset, window):
        q, k, v, dout, lse, delta = self._inputs(
            [("q", q), ("k", k), ("v", v), ("dout", dout)],
            [("lse", lse), ("delta", delta)],
        )
        dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.empty_like(dk)
        self._launch(
            q, k, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_strides(q), *_strides(k), *_strides(v), *_strides(dout),
            *_strides(dk), *_strides(dv),
            float(scale), int(causal), int(window or 0), int(q_offset),
            int(k_offset),
        )
        return dk, dv


flash_fwd_kernel = FlashForwardKernel()
flash_tile_kernel = FlashTileKernel()
flash_bwd_dq_kernel = FlashBwdDqKernel()
flash_bwd_dkv_kernel = FlashBwdDkvKernel()
KERNELS = {
    "flash_fwd": flash_fwd_kernel,
    "flash_fwd_tile": flash_tile_kernel,
    "flash_bwd_dq": flash_bwd_dq_kernel,
    "flash_bwd_dkv": flash_bwd_dkv_kernel,
}


def _on_cuda(q: torch.Tensor) -> bool:
    """Whether q takes the kernels (CUDA) or their plain versions (CPU).
    Both refuse what the kernels refuse: a head dim past MAX_HEAD_DIM."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, got {q.device}")
    kernel_head_dim(q.shape[-1])
    return q.device.type == "cuda"


def flash_attention_tile(q, k, v, causal=False, scale=None, q_offset=0,
                         k_offset=0, window=None):
    """B1 for CUDA tensors, its plain version for CPU tensors."""
    fn = flash_tile_kernel if _on_cuda(q) else flash_attention_tile_plain
    return fn(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset, window=window)


def flash_attention_bwd_tile(q, k, v, dout, lse, delta, causal=False,
                             scale=None, q_offset=0, k_offset=0, window=None):
    """(dq, dk, dv) in f32: B3 then B4 for CUDA tensors, their plain
    version for CPU tensors."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset, window=window)
    if not _on_cuda(q):
        return flash_attention_bwd_plain(q, k, v, dout, lse, delta, **kw)
    dq = flash_bwd_dq_kernel(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_kernel(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


class _NoSecondDerivative(torch.autograd.Function):
    """Passes a gradient of FlashAttentionFunction through, on a graph
    node whose inputs are the attention's inputs and whose backward
    raises. torch's @once_differentiable hangs its error node off detached
    copies of the gradients, so torch.autograd.grad(..., inputs) never
    reaches it and drops the attention term silently; this node lies on
    the path to the inputs."""

    @staticmethod
    def forward(ctx, grad, *inputs):
        del inputs
        return grad.clone()

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "flash attention is once-differentiable: its backward (B3, B4 "
            "or their plain versions) gives gradients with no graph, so a "
            "second derivative through it is not supported; use the einsum "
            "path (use_flash=False)"
        )


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its explicit backward, the JAX package's
    custom VJP (`_fwd`/`_bwd`): forward through B1, normalized here with l
    floored at 1e-30, saving (q, k, v, out, lse = m + log l); backward
    through delta, B3 and B4, with grads cast to the input dtypes.

    The backward is once-differentiable on both devices (CPU tensors take
    this Function too, with the plain versions): under create_graph its
    gradients come through _NoSecondDerivative, so a second derivative
    through attention raises instead of losing the attention term."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, k_offset, window):
        o, l, m = flash_attention_tile(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            k_offset=k_offset, window=window,
        )
        l_safe = l.clamp_min(1e-30)
        out = (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l_safe))
        ctx.args = dict(causal=causal, scale=scale, q_offset=q_offset,
                        k_offset=k_offset, window=window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with torch.no_grad():
            dq, dk, dv = flash_attention_bwd_tile(
                q, k, v, dout, lse, flash_attention_bwd_delta(dout, out),
                **ctx.args,
            )
        grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
        if torch.is_grad_enabled():  # create_graph=True
            grads = tuple(
                _NoSecondDerivative.apply(g, q, k, v, dout) for g in grads
            )
        return grads + (None,) * 5


@torch.library.custom_op("t2r_torch::flash_fwd", mutates_args=())
def flash_fwd_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool,
    scale: float,
    q_offset: int,
    k_offset: int,
    window: Optional[int],
) -> torch.Tensor:
    """B2 as one operator, the entry an exported program records: the
    kernel for CUDA tensors, its plain version for CPU tensors. A program
    traced on either device holds this node, so it launches B2 wherever it
    is moved to the card; a traced ctypes launch would not survive."""
    fn = flash_fwd_kernel if _on_cuda(q) else flash_attention_plain
    return fn(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset, window=window).contiguous()


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, q_offset, k_offset, window):
    return q.new_empty(q.shape)


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
    """Flash attention over [B, S, H, D]. With grad enabled and any input
    requiring grad: FlashAttentionFunction (B1 forward, B3+B4 backward).
    Otherwise the normalized forward through the operator
    `t2r_torch::flash_fwd` (flash_fwd_op): B2 for CUDA tensors, its plain
    version for CPU tensors."""
    _check_window(window, causal)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    # A flash head never lowers: the serving contraction override is
    # suppressed for the kernel and its plain version alike.
    with attention_contraction_override(None):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            _on_cuda(q)
            return FlashAttentionFunction.apply(
                q, k, v, causal, scale, q_offset, k_offset, window
            )
        _on_cuda(q)  # refuses a head dim past MAX_HEAD_DIM before a trace does
        return flash_fwd_op(q, k, v, causal, scale, q_offset, k_offset, window)
