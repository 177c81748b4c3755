"""SNAIL attention meta-learner blocks (arXiv:1707.03141).

Port of tensor2robot_tpu/layers/snail.py: CausalConv, DenseBlock,
TCBlock, causally_masked_softmax and AttentionBlock over [batch, time,
channels]. A causal conv pads dilation * (kernel - 1) on the left only
and runs VALID; the attention masks positions after the query with -inf
and runs as plain einsums (the JAX package computes it outside any
Pallas kernel too). Modules are named as the flax modules are
(CausalConv's conv `Conv_0`, DenseBlock's `xf`/`xg`, TCBlock's
`DenseBlock_{i}`, AttentionBlock's `key`/`query`/`value`); each takes its
input width at construction.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class CausalConv(nn.Module):
    """Causal dilated 1D convolution over [batch, time, channels]."""

    def __init__(self, in_channels: int, filters: int, dilation_rate: int = 1,
                 kernel_size: int = 2):
        super().__init__()
        self.causal_pad = (kernel_size - 1) * dilation_rate
        self.Conv_0 = nn.Conv1d(in_channels, filters, kernel_size, dilation=dilation_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x.transpose(1, 2), (self.causal_pad, 0))
        return self.Conv_0(x).transpose(1, 2)


class DenseBlock(nn.Module):
    """Gated causal-conv activations concatenated onto the input."""

    def __init__(self, in_channels: int, filters: int, dilation_rate: int = 1):
        super().__init__()
        self.xf = CausalConv(in_channels, filters, dilation_rate)
        self.xg = CausalConv(in_channels, filters, dilation_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        activations = torch.tanh(self.xf(x)) * torch.sigmoid(self.xg(x))
        return torch.cat([x, activations], dim=2)


class TCBlock(nn.Module):
    """DenseBlocks with dilations 2^1 .. 2^ceil(log2(T)); the output has
    in_channels + that many * filters channels."""

    def __init__(self, in_channels: int, sequence_length: int, filters: int):
        super().__init__()
        self.num_blocks = int(math.ceil(math.log2(sequence_length)))
        for i in range(1, self.num_blocks + 1):
            self.add_module(f"DenseBlock_{i}", DenseBlock(in_channels, filters, 2 ** i))
            in_channels += filters
        self.out_channels = in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.num_blocks + 1):
            x = getattr(self, f"DenseBlock_{i}")(x)
        return x


def causally_masked_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with positions j > i masked out."""
    t = logits.shape[-1]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=logits.device))
    return torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)


class AttentionBlock(nn.Module):
    """Single-head causal self-attention whose read is concatenated onto
    the input. Returns (result, end_points)."""

    def __init__(self, in_channels: int, key_size: int, value_size: int):
        super().__init__()
        self.key_size = key_size
        self.key = nn.Linear(in_channels, key_size)
        self.query = nn.Linear(in_channels, key_size)
        self.value = nn.Linear(in_channels, value_size)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits = torch.einsum("btk,bsk->bts", self.query(x), self.key(x))
        probs = causally_masked_softmax(logits / math.sqrt(self.key_size))
        read = torch.einsum("bts,bsv->btv", probs, self.value(x))
        return torch.cat([x, read], dim=2), {"attn_prob": probs}
