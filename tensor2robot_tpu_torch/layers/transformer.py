"""Transformer blocks over the attention hot op.

Port of tensor2robot_tpu/layers/transformer.py: a pre-norm transformer
whose single-device attention routes through ops/flash_attention — the
einsum path (`reference_attention`) or the flash path (the CUDA kernel on
the card, its plain recurrence on the CPU). Parameter names and layouts
mirror the flax modules (qkv/out, ln_attn/ln_mlp, mlp_in/mlp_out,
pos_embedding, block_<i>, ln_final), so utils/jax_params.py maps a flax
params tree onto these modules one to one.

Not ported yet, and rejected with NotImplementedError naming their
ROADMAP.md item: KV-cache decode (A6), mixture-of-experts feed-forwards
(A8), and the mesh paths — sequence-parallel ring/ulysses attention and
pipelining (A9).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.ops import flash_attention as flash_lib

# flax.linen.LayerNorm's epsilon (torch's default is 1e-5).
LAYER_NORM_EPS = 1e-6


def _reject_unported(
    decode: bool = False,
    mesh: Optional[object] = None,
    num_experts: int = 1,
    pipeline_stages: int = 1,
) -> None:
    if decode:
        raise NotImplementedError(
            "KV-cache decode is not ported yet (ROADMAP.md A6)"
        )
    if mesh is not None or pipeline_stages > 1:
        raise NotImplementedError(
            "mesh paths (sequence-parallel attention, pipelining) are not "
            "ported yet (ROADMAP.md A9)"
        )
    if num_experts > 1:
        raise NotImplementedError(
            "mixture-of-experts feed-forwards are not ported yet "
            "(ROADMAP.md A8)"
        )


class MultiHeadAttention(nn.Module):
    """Self-attention over [batch, seq, features] with a fused qkv
    projection, grouped-query K/V (num_kv_heads < num_heads) and an
    optional causal sliding window.

    use_flash: None = auto (flash at seq >= FLASH_AUTO_SEQ, else einsum),
    True = always the flash path, False = always the einsum path.
    """

    def __init__(
        self,
        features: int,
        num_heads: int,
        head_dim: int,
        causal: bool = True,
        use_flash: Optional[bool] = None,
        window: Optional[int] = None,
        num_kv_heads: Optional[int] = None,
        decode: bool = False,
        mesh: Optional[object] = None,
    ):
        super().__init__()
        _reject_unported(decode=decode, mesh=mesh)
        kv_heads = num_kv_heads if num_kv_heads is not None else num_heads
        if num_heads % kv_heads != 0:
            raise ValueError(
                f"num_heads={num_heads} must be divisible by "
                f"num_kv_heads={kv_heads}"
            )
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.kv_heads = kv_heads
        self.causal = causal
        self.use_flash = use_flash
        self.window = window
        inner = num_heads * head_dim
        self.qkv = nn.Linear(
            features, inner + 2 * kv_heads * head_dim, bias=False
        )
        self.out = nn.Linear(inner, features, bias=False)

    def _expand_kv(self, t: torch.Tensor) -> torch.Tensor:
        """[B, S, KVH, D] -> [B, S, H, D]: each kv head repeated over its
        query group (no-op for standard MHA)."""
        groups = self.num_heads // t.shape[2]
        return t if groups == 1 else t.repeat_interleave(groups, dim=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        batch, seq, _ = x.shape
        inner = self.num_heads * self.head_dim
        kv_inner = self.kv_heads * self.head_dim
        q, k, v = self.qkv(x).split([inner, kv_inner, kv_inner], dim=-1)
        # Views into the fused projection; the flash kernel reads them by
        # stride without a copy.
        q = q.view(batch, seq, self.num_heads, self.head_dim)
        k = self._expand_kv(k.view(batch, seq, self.kv_heads, self.head_dim))
        v = self._expand_kv(v.view(batch, seq, self.kv_heads, self.head_dim))
        use_flash = self.use_flash
        if use_flash is None:
            use_flash = seq >= flash_lib.FLASH_AUTO_SEQ
        attend = (
            flash_lib.flash_attention if use_flash
            else flash_lib.reference_attention
        )
        out = attend(q, k, v, causal=self.causal, window=self.window)
        return self.out(out.reshape(batch, seq, inner))


class TransformerBlock(nn.Module):
    """Pre-norm block: x + MHA(LN(x)); x + FFN(LN(x)), dense FFN with the
    tanh-approximated GELU (flax nn.gelu's default)."""

    def __init__(
        self,
        features: int,
        num_heads: int,
        head_dim: int,
        mlp_ratio: int = 4,
        causal: bool = True,
        use_flash: Optional[bool] = None,
        window: Optional[int] = None,
        num_kv_heads: Optional[int] = None,
        num_experts: int = 1,
        decode: bool = False,
        mesh: Optional[object] = None,
    ):
        super().__init__()
        _reject_unported(num_experts=num_experts)
        self.attention = MultiHeadAttention(
            features, num_heads, head_dim, causal=causal, use_flash=use_flash,
            window=window, num_kv_heads=num_kv_heads, decode=decode, mesh=mesh,
        )
        self.ln_attn = nn.LayerNorm(features, eps=LAYER_NORM_EPS)
        self.ln_mlp = nn.LayerNorm(features, eps=LAYER_NORM_EPS)
        self.mlp_in = nn.Linear(features, mlp_ratio * features)
        self.mlp_out = nn.Linear(mlp_ratio * features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.ln_attn(x))
        h = F.gelu(self.mlp_in(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerEncoder(nn.Module):
    """N pre-norm blocks with learned positional embeddings over
    [batch, seq, features]; final LayerNorm."""

    def __init__(
        self,
        features: int,
        num_layers: int,
        num_heads: int,
        head_dim: int,
        max_seq_len: int = 2048,
        mlp_ratio: int = 4,
        causal: bool = True,
        use_flash: Optional[bool] = None,
        window: Optional[int] = None,
        num_kv_heads: Optional[int] = None,
        num_experts: int = 1,
        decode: bool = False,
        mesh: Optional[object] = None,
        pipeline_stages: int = 1,
    ):
        super().__init__()
        _reject_unported(
            decode=decode, mesh=mesh, num_experts=num_experts,
            pipeline_stages=pipeline_stages,
        )
        self.max_seq_len = max_seq_len
        self.pos_embedding = nn.Parameter(torch.zeros(max_seq_len, features))
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(
                f"block_{i}",
                TransformerBlock(
                    features, num_heads, head_dim, mlp_ratio=mlp_ratio,
                    causal=causal, use_flash=use_flash, window=window,
                    num_kv_heads=num_kv_heads,
                ),
            )
        self.ln_final = nn.LayerNorm(features, eps=LAYER_NORM_EPS)

    def init_own_parameters(self, generator: torch.Generator) -> None:
        """flax's normal(0.02) initializer for the position table."""
        with torch.no_grad():
            nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x.shape[1]
        if seq > self.max_seq_len:
            raise ValueError(
                f"sequence length {seq} exceeds max_seq_len={self.max_seq_len}"
            )
        x = x + self.pos_embedding[None, :seq]
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x)
        return self.ln_final(x)
