"""Ring attention: sequence parallelism over the mesh's `sequence` dim.

Port of tensor2robot_tpu/parallel/ring_attention.py. Q/K/V are sharded
along the sequence: each rank keeps its Q shard and its K/V block, and the
K/V blocks rotate around the ring (`ppermute` to the next rank), so after
hop i a rank holds the block of the rank i places upstream. Each hop
attends its Q shard to the block at GLOBAL positions (q_offset = my index
x block, k_offset = the source's index x block) and merges the tile into
running online-softmax state (o, l, m). Memory per rank stays O(S / N).

The port runs multi-controller: every function here takes this rank's
LOCAL shards [B, S/N, H, D] and runs the per-rank body that the JAX
package's shard_map runs per device. So `ring_attention` (JAX: the entry
that owns its shard_map) and `ring_attention_manual` (JAX: the entry for a
caller already inside one) are the same per-rank code here; they differ in
the tile, as in JAX: `ring_attention` takes the flash tile by its
use_flash policy, `ring_attention_manual` always the einsum tile.

The flash ring is `RingFlashAttentionFunction`, the counterpart of JAX's
`_ring_flash` custom VJP: its forward runs B1 (`flash_attention_tile`,
csrc/flash_fwd.cu on the card) once per hop and keeps lse = m + log l; its
backward computes delta once and runs B3 and B4 (`flash_attention_bwd_tile`,
csrc/flash_bwd.cu) once per hop from the global row stats, dq staying home
and dk/dv traveling WITH their k/v blocks, so each block's gradient arrives
home carrying every rank's contribution. With a causal window the ring
truncates to `_ring_hops` hops, and the traveling dk/dv take one more shift
home at the end. On CPU tensors the tiles are the kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from tensor2robot_tpu_torch.ops import flash_attention as flash_lib
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel.mesh import SEQUENCE_AXIS, axis_size

_NEG_INF = -1e30


def _ring_hops(axis_size: int, block: int, causal: bool,
               window: Optional[int]) -> int:
    """Hops the ring needs. Visibility of the block arriving at hop i
    depends only on i (src = me - i uniformly), so with a causal window W
    over per-rank shards of length B, every hop past floor((W + B - 2) / B)
    delivers a fully-masked tile on EVERY rank — the ring truncates to
    that many hops, rank-uniformly."""
    if not causal or window is None:
        return axis_size
    return min(axis_size, (window + block - 2) // block + 1)


def _block_attend(q, k_blk, v_blk, q_offset, k_offset, scale, causal,
                  window=None):
    """One (q-shard x k-block) einsum tile: (o_partial, row_sum, row_max)
    in the online-softmax decomposition; a fully masked row gives 0."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k_blk.shape[1], device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(mask[None, None], s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)  # [B, H, Sq]
    p = torch.exp(s - m[..., None])
    # Fully-masked tiles: zero contribution, not exp(0) = 1 garbage.
    p = torch.where((m == _NEG_INF)[..., None], torch.zeros_like(p), p)
    l = p.sum(dim=-1)  # [B, H, Sq]
    o = torch.einsum("bhqk,bkhd->bqhd", p, v_blk)
    return o, l, m


def _ring_perm(n: int, shift: int = 1):
    return [(j, (j + shift) % n) for j in range(n)]


def _merge(state, tile):
    """Online-softmax merge of a tile (o [B,S,H,D], l, m [B,H,S]) into the
    running state."""
    o_acc, l_acc, m_acc = state
    o_blk, l_blk, m_blk = tile
    m_new = torch.maximum(m_acc, m_blk)
    alpha = torch.exp(m_acc - m_new)
    beta = torch.exp(m_blk - m_new)
    l_new = l_acc * alpha + l_blk * beta
    o_new = (o_acc * alpha.transpose(1, 2)[..., None]
             + o_blk.float() * beta.transpose(1, 2)[..., None])
    return o_new, l_new, m_new


def _ring_forward(q, k, v, mesh, axis_name, causal, scale, window, use_flash):
    """The per-rank forward ring: (out in q's dtype, l, m), l floored at
    1e-30. With use_flash each hop is B1, else the einsum tile (then the
    whole ring is differentiable through collectives.ppermute)."""
    n = axis_size(mesh, axis_name)
    me = collectives.axis_index(mesh, axis_name)
    batch, block, heads, _ = q.shape
    state = (
        torch.zeros(q.shape, dtype=torch.float32, device=q.device),
        torch.zeros((batch, heads, block), dtype=torch.float32, device=q.device),
        torch.full((batch, heads, block), _NEG_INF, dtype=torch.float32,
                   device=q.device),
    )
    perm = _ring_perm(n)
    hops = _ring_hops(n, block, causal, window)
    k_blk, v_blk = k, v
    for i in range(hops):
        src = (me - i) % n
        if use_flash:
            tile = flash_lib.flash_attention_tile(
                q, k_blk, v_blk, causal=causal, scale=scale,
                q_offset=me * block, k_offset=src * block, window=window,
            )
        else:
            tile = _block_attend(q, k_blk, v_blk, me * block, src * block,
                                 scale, causal, window)
        state = _merge(state, tile)
        if i + 1 < hops:  # the last hop's rotation would go unread
            k_blk = collectives.ppermute(k_blk, mesh, axis_name, perm)
            v_blk = collectives.ppermute(v_blk, mesh, axis_name, perm)
    o_acc, l_acc, m_acc = state
    l_acc = l_acc.clamp_min(1e-30)
    out = (o_acc / l_acc.transpose(1, 2)[..., None]).to(q.dtype)
    return out, l_acc, m_acc


class RingFlashAttentionFunction(torch.autograd.Function):
    """The flash ring with its flash ring backward (JAX `_ring_flash`'s
    custom VJP): forward B1 once per hop, saving (q, k, v, out, lse);
    backward delta once, then B3 and B4 once per hop, dk/dv riding the ring
    with their blocks. Once-differentiable, as FlashAttentionFunction."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal, scale, window):
        out, l, m = _ring_forward(q, k, v, mesh, axis_name, causal, scale,
                                  window, use_flash=True)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.args = (mesh, axis_name, causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis_name, causal, scale, window = ctx.args
        with torch.no_grad():
            dq, dk, dv = _ring_backward(q, k, v, dout.contiguous(), out, lse,
                                        mesh, axis_name, causal, scale, window)
        grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
        if torch.is_grad_enabled():  # create_graph=True
            grads = tuple(
                flash_lib._NoSecondDerivative.apply(g, q, k, v, dout)
                for g in grads
            )
        return grads + (None,) * 5


def _ring_backward(q, k, v, dout, out, lse, mesh, axis_name, causal, scale,
                   window):
    """Backward ring: dq accumulates on the q owner; dk/dv contributions
    travel with their k/v blocks and arrive home after the rotation (plus
    the one shift home of a truncated ring)."""
    n = axis_size(mesh, axis_name)
    me = collectives.axis_index(mesh, axis_name)
    block = q.shape[1]
    delta = flash_lib.flash_attention_bwd_delta(dout, out)  # [B, H, Sq]
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_travel = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_travel = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    perm = _ring_perm(n)
    hops = _ring_hops(n, block, causal, window)
    k_blk, v_blk = k, v
    for i in range(hops):
        src = (me - i) % n
        dq_t, dk_t, dv_t = flash_lib.flash_attention_bwd_tile(
            q, k_blk, v_blk, dout, lse, delta, causal=causal, scale=scale,
            q_offset=me * block, k_offset=src * block, window=window,
        )
        dq_acc += dq_t
        dk_travel += dk_t
        dv_travel += dv_t
        # The block's accumulated gradient rotates with it; the last
        # rotation delivers it home (a full ring) or `hops` shifts on.
        dk_travel = collectives.ppermute(dk_travel, mesh, axis_name, perm)
        dv_travel = collectives.ppermute(dv_travel, mesh, axis_name, perm)
        if i + 1 < hops:
            k_blk = collectives.ppermute(k_blk, mesh, axis_name, perm)
            v_blk = collectives.ppermute(v_blk, mesh, axis_name, perm)
    if hops < n:
        # A truncated rotation leaves each traveling gradient `hops` shifts
        # from home; one ppermute with the remaining shift delivers it.
        home = _ring_perm(n, n - hops)
        dk_travel = collectives.ppermute(dk_travel, mesh, axis_name, home)
        dv_travel = collectives.ppermute(dv_travel, mesh, axis_name, home)
    return dq_acc, dk_travel, dv_travel


def _check_local(q, mesh):
    if q.ndim != 4:
        raise ValueError(f"Expected [B, S_local, H, D], got {tuple(q.shape)}")
    if mesh is None:
        raise ValueError("ring attention needs the mesh")


def ring_attention_manual(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh: DeviceMesh,
    axis_name: str = SEQUENCE_AXIS,
    causal: bool = False,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """JAX's manual entry point (used inside an enclosing shard_map): here
    the same per-rank code, `ring_attention` with the einsum tile."""
    return ring_attention(q, k, v, mesh, axis_name, causal, scale,
                          use_flash=False, window=window)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    axis_name: str = SEQUENCE_AXIS,
    causal: bool = False,
    scale: Optional[float] = None,
    use_flash: Optional[bool] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Sequence-parallel attention on this rank's shards [B, S/N, H, D] of
    a sequence split over `mesh`'s `axis_name`; returns this rank's shard
    of the output.

    use_flash: None = JAX's policy, the flash tiles when the per-hop LOCAL
    length S/N reaches FLASH_AUTO_SEQ (where the einsum tiles' [S/N, S/N]
    logits become the memory hazard), else the einsum ring. True forces
    RingFlashAttentionFunction (B1 per hop; B3 + B4 per hop backward),
    False the einsum ring.
    """
    _check_local(q, mesh)
    flash_lib._check_window(window, causal)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if use_flash is None:
        use_flash = q.shape[1] >= flash_lib.FLASH_AUTO_SEQ
    if not use_flash:
        out, _, _ = _ring_forward(q, k, v, mesh, axis_name, causal, scale,
                                  window, use_flash=False)
        return out
    flash_lib._on_cuda(q)  # refuses a device or head dim the kernels refuse
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RingFlashAttentionFunction.apply(
            q, k, v, mesh, axis_name, causal, scale, window
        )
    out, _, _ = _ring_forward(q, k, v, mesh, axis_name, causal, scale, window,
                              use_flash=True)
    return out
