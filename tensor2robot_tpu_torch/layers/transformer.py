"""Transformer blocks over the attention hot op.

Port of tensor2robot_tpu/layers/transformer.py: a pre-norm transformer
whose single-device attention routes through ops/flash_attention — the
einsum path (`reference_attention`) or the flash path (the CUDA kernel on
the card, its plain recurrence on the CPU). Parameter names and layouts
mirror the flax modules (qkv/out, ln_attn/ln_mlp, mlp_in/mlp_out or moe,
pos_embedding, block_<i>, ln_final), so utils/jax_params.py maps a flax
params tree onto these modules one to one.

`num_experts > 1` swaps a block's dense feed-forward for the MoE of
layers/moe.py. Its router aux loss is part of what the block returns
(`(y, aux_loss)`, aux_loss None for a dense block), and the encoder returns
every block's, so remat's rerun and torch.func see it as an output.

Decode (`decode=True`) is the streaming-serving mode: each call carries ONE
new step, appended to a K/V cache and attended against the cached prefix.
The cache is an explicit `DecodeCache` over a flat dict of tensors, keyed
by the flax "cache" collection's paths ('block_0/attention/cached_key'),
threaded through the forward; every counter stays a device tensor, so a
step can be captured as one CUDA graph or traced by torch.export.

Sequence parallelism (`mesh` with a `sequence` dim above 1): attention
runs as the ring (parallel/ring_attention.py, `sequence_parallel_mode=
"ring"`, the default) or Ulysses (parallel/ulysses_attention.py, "ulysses")
over this rank's shard of the sequence. The encoder adds the positional
table on the global [B, S, F] input (as JAX does), takes this rank's shard
[B, S/N, F], runs the blocks and ln_final on it, and all_gathers the
shards back to [B, S, F], so the head, the loss and the specs see the
global episode unchanged.

The gradient rule under a mesh: every sequence rank computes the same
loss on the same global output. The all_gather's backward is psum_scatter,
so each rank's shard receives the sum of the N equal cotangents: N times
its share of the single-device gradient. A parameter's gradient on rank r
is then N x the part of the single-device gradient that flows through
shard r (the layers inside the encoder, and through the slice also the
embed below it), or the whole single-device gradient (the head above the
gather). The pmean over the sequence ranks (the trainer's gradient
bucket) turns both into the single-device gradient; the pmean over data x
fsdp then averages the data shards' means into the global batch mean.

Expert parallelism (`mesh` with an `expert` dim above 1): each block's
MoE computes only this rank's resident experts (ops/moe.py has the rule);
expert ranks share their batch and run everything else whole. Under a
sequence dim above 1 a block's MoE gathers the episode's shards before
routing and slices this rank's back after the combine (layers/moe.py), so
routing sees whole episodes as in JAX; the gradient rule above holds
through it.

Pipelining (`pipeline_stages` = S > 1 over a mesh whose `pipe` dim is S):
the blocks split into S equal stages and pipe rank s holds only stage s's
blocks, as the module `pipe_stages` (a `PipelineStage`: its `block_<b>`
is the chain's block s * L/S + b). The batch streams through in
`pipeline_microbatches` microbatches (parallel/pipeline.py's GPipe
schedule); the positional table, ln_final and everything outside the
encoder stay whole on every rank. Each stage's attention follows the
single-device policy (use_flash: B1 forward and B3/B4 backward under
autograd, B2 without), or, over a `sequence` dim above 1, the manual ring
or Ulysses (`manual_sequence_size`, the einsum tiles, as JAX's manual
entries): the local sequence is sliced before the pipeline and gathered
after ln_final, as above. The state dict holds the stage's blocks under
`pipe_stages.block_<b>`; `load_state_dict` also takes the stacked
[S, ...] layout of the JAX tree and of the trainer's checkpoints (this
rank's slice) and the chain's `block_<i>` (this stage's blocks), and a
plain encoder takes the stacked layout as its chain (stage s's block b is
block s * L/S + b), so a pipelined checkpoint serves on one card.

Decode takes a mesh whose sequence dim is 1 (each rank decodes its
requests; an expert dim splits the MoE as in training) and refuses a
sequence dim above 1 with JAX's ValueError: decode is single-device
serving. MoE inside a pipeline raises JAX's ValueError too. A mesh with
fsdp or model dims above 1 is the trainer's sharded_params regime
(parallel/sharded_params.py), which composes with the sequence, pipe and
expert dims here.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import remat
from tensor2robot_tpu_torch.layers.moe import MoEBlock
from tensor2robot_tpu_torch.ops import flash_attention as flash_lib
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel import pipeline
from tensor2robot_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_manual,
)
from tensor2robot_tpu_torch.parallel.ulysses_attention import (
    ulysses_attention,
    ulysses_attention_manual,
)

# flax.linen.LayerNorm's epsilon (torch's default is 1e-5).
LAYER_NORM_EPS = 1e-6
# sequence_parallel_mode -> the attention a sequence mesh runs, and the
# manual entry a pipeline stage's blocks run (always the einsum tiles).
SEQUENCE_PARALLEL = {"ring": ring_attention, "ulysses": ulysses_attention}
MANUAL_SEQUENCE_PARALLEL = {"ring": ring_attention_manual,
                            "ulysses": ulysses_attention_manual}


def _check_mesh(
    mesh: Optional[object] = None,
    sequence_parallel_mode: str = "ring",
    manual_sequence_size: int = 1,
    decode: bool = False,
) -> None:
    """Eager checks of the parallel arguments: a mode typo fails on the
    laptop run (ValueError, as JAX), a mesh of the wrong type with a
    TypeError, a manual sequence size that is not the mesh's with a
    ValueError, and decoding over a sequence dim above 1 with JAX's
    ValueError (JAX raises it at the decode step; here at construction)."""
    if sequence_parallel_mode not in SEQUENCE_PARALLEL:
        raise ValueError(
            "sequence_parallel_mode must be 'ring' or 'ulysses', "
            f"got {sequence_parallel_mode!r}"
        )
    if manual_sequence_size > 1 and _sequence_size(mesh) != manual_sequence_size:
        raise ValueError(
            f"manual_sequence_size={manual_sequence_size} needs the mesh whose "
            f"sequence dim it names (got {_sequence_size(mesh)})"
        )
    if mesh is None:
        return
    mesh_lib.check_mesh(mesh)
    if decode and _sequence_size(mesh) > 1:
        raise ValueError(
            "decode mode is single-device (serving); drop the "
            "sequence-parallel mesh"
        )


def _check_pipeline(
    num_layers: int,
    pipeline_stages: int,
    num_experts: int,
    mesh: Optional[object],
    sequence_parallel_mode: str,
    num_heads: int,
    decode: bool,
) -> None:
    """JAX's composition rules of a pipelined encoder
    (`_pipelined_blocks`), each with its ValueError, in its order."""
    if pipeline_stages <= 1:
        return
    if decode:
        raise ValueError("decode mode does not compose with pipelining")
    if num_layers % pipeline_stages != 0:
        raise ValueError(
            f"num_layers={num_layers} not divisible by "
            f"pipeline_stages={pipeline_stages}"
        )
    if num_experts > 1:
        raise ValueError(
            "pipeline_stages > 1 does not compose with MoE feed-"
            "forwards (the router aux-loss channel does not cross the "
            "pipeline schedule)"
        )
    if mesh is None:
        raise ValueError("pipeline_stages > 1 requires a mesh")
    shape = mesh_lib.mesh_shape(mesh)
    if shape[mesh_lib.PIPE_AXIS] != pipeline_stages:
        raise ValueError(
            f"mesh pipe axis {shape[mesh_lib.PIPE_AXIS]} "
            f"!= pipeline_stages={pipeline_stages}"
        )
    seq_size = shape[mesh_lib.SEQUENCE_AXIS]
    if seq_size > 1 and sequence_parallel_mode not in SEQUENCE_PARALLEL:
        raise ValueError(
            "pipeline_stages > 1 composes with sequence parallelism "
            "in ring or ulysses mode (the in-shard_map manual "
            "strategies); got "
            f"sequence_parallel_mode={sequence_parallel_mode!r}"
        )
    if (seq_size > 1 and sequence_parallel_mode == "ulysses"
            and num_heads % seq_size != 0):
        raise ValueError(
            f"ulysses inside the pipeline needs num_heads="
            f"{num_heads} divisible by the sequence axis size "
            f"{seq_size} (each device owns whole heads after the "
            "all_to_all scatter); use ring mode otherwise"
        )


def _sequence_size(mesh: Optional[object]) -> int:
    return mesh_lib.axis_size(mesh, mesh_lib.SEQUENCE_AXIS)


class DecodeCache:
    """One decode step's view of the cache: reads the incoming tensors and
    records the new ones, in one flat dict keyed by '/'-joined paths.

    `tensors` is copied on entry; a module reads its own entries before it
    writes them, and `child(name)` scopes a submodule's keys under
    `name/`. After the step, `tensors` holds the whole updated cache.
    """

    def __init__(self, tensors: Dict[str, torch.Tensor], prefix: str = ""):
        self.tensors = tensors
        self.prefix = prefix

    def child(self, name: str) -> "DecodeCache":
        return DecodeCache(self.tensors, f"{self.prefix}{name}/")

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.tensors[self.prefix + name]

    def __setitem__(self, name: str, value: torch.Tensor) -> None:
        self.tensors[self.prefix + name] = value


def _check_decode(decode: bool, cache: Optional[DecodeCache]) -> None:
    if decode and cache is None:
        raise ValueError("a decode-mode module needs the decode cache")
    if not decode and cache is not None:
        raise ValueError("a cache was given to a module not in decode mode")


class MultiHeadAttention(nn.Module):
    """Self-attention over [batch, seq, features] with a fused qkv
    projection, grouped-query K/V (num_kv_heads < num_heads) and an
    optional causal sliding window.

    use_flash: None = auto (flash at seq >= FLASH_AUTO_SEQ, else einsum),
    True = always the flash path, False = always the einsum path.

    mesh: with a `sequence` dim above 1, x is this rank's sequence shard
    and attention runs sequence-parallel: the ring, or Ulysses with
    `sequence_parallel_mode="ulysses"`, each with its own use_flash policy
    (None = auto on the length it attends).

    manual_sequence_size: above 1, x is this rank's sequence shard inside
    a pipeline stage and attention is the manual entry of the mode over
    the mesh's sequence dim (of that size), the einsum tiles whatever
    use_flash says (JAX's `ring_attention_manual`,
    `ulysses_attention_manual`).

    decode: one step per call against a K/V cache of `decode_max_len`
    slots, `kv_heads` wide (GQA expands heads only at attend time); see
    `_decode_step`.
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
        decode_max_len: int = 2048,
        mesh: Optional[object] = None,
        sequence_parallel_mode: str = "ring",
        manual_sequence_size: int = 1,
    ):
        super().__init__()
        _check_mesh(mesh, sequence_parallel_mode, manual_sequence_size, decode=decode)
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
        self.decode = decode
        self.decode_max_len = decode_max_len
        self.mesh = mesh
        self.sequence_parallel_mode = sequence_parallel_mode
        self.manual_sequence_size = manual_sequence_size
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

    def init_cache(
        self, batch: int, cache: DecodeCache, dtype: torch.dtype,
        device: torch.device,
    ) -> None:
        """Writes this module's zeroed cache entries (the episode start)."""
        shape = (batch, self.decode_max_len, self.kv_heads, self.head_dim)
        cache["cached_key"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["cached_value"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["cache_index"] = torch.zeros((), dtype=torch.int32, device=device)

    def forward(
        self, x: torch.Tensor, cache: Optional[DecodeCache] = None
    ) -> torch.Tensor:
        _check_decode(self.decode, cache)
        batch, seq, _ = x.shape
        inner = self.num_heads * self.head_dim
        kv_inner = self.kv_heads * self.head_dim
        q, k, v = self.qkv(x).split([inner, kv_inner, kv_inner], dim=-1)
        # Views into the fused projection; the flash kernel reads them by
        # stride without a copy.
        q = q.view(batch, seq, self.num_heads, self.head_dim)
        k = k.view(batch, seq, self.kv_heads, self.head_dim)
        v = v.view(batch, seq, self.kv_heads, self.head_dim)
        if self.decode:
            out = self._decode_step(q, k, v, cache)
            return self.out(out.reshape(batch, seq, inner))
        # The flash, ring and Ulysses paths take equal q/k/v head counts.
        k, v = self._expand_kv(k), self._expand_kv(v)
        if self.manual_sequence_size > 1:
            out = MANUAL_SEQUENCE_PARALLEL[self.sequence_parallel_mode](
                q, k, v, mesh=self.mesh, causal=self.causal, window=self.window)
            return self.out(out.reshape(batch, seq, inner))
        if _sequence_size(self.mesh) > 1:
            out = SEQUENCE_PARALLEL[self.sequence_parallel_mode](
                q, k, v, self.mesh, causal=self.causal, use_flash=self.use_flash,
                window=self.window)
            return self.out(out.reshape(batch, seq, inner))
        use_flash = self.use_flash
        if use_flash is None:
            use_flash = seq >= flash_lib.FLASH_AUTO_SEQ
        attend = (
            flash_lib.flash_attention if use_flash
            else flash_lib.reference_attention
        )
        out = attend(q, k, v, causal=self.causal, window=self.window)
        return self.out(out.reshape(batch, seq, inner))

    def _decode_step(self, q, k, v, cache: DecodeCache) -> torch.Tensor:
        """Writes this step's k/v at slot `cache_index` and attends q
        against the cache. With a window, attention reads only the last
        `span = min(window, max_len)` slots from the clamped start
        clip(i - span + 1, 0, max_len - span), so a step costs O(window).

        Past capacity the slot clamps to the last one (as JAX's
        dynamic_update_slice clamps its start) while `i`, the query's
        position, keeps counting. Offsets stay device tensors.
        """
        if not self.causal:
            raise ValueError("decode mode requires causal=True")
        seq = q.shape[1]
        if seq != 1:
            raise ValueError(
                f"decode mode consumes ONE step per call, got seq={seq}; "
                "run the full-sequence forward for teacher forcing"
            )
        max_len = self.decode_max_len
        i = cache["cache_index"]
        slot = torch.clamp(i, max=max_len - 1).to(torch.int64).reshape(1)
        cached_k = cache["cached_key"].index_copy(1, slot, k.to(cache["cached_key"].dtype))
        cached_v = cache["cached_value"].index_copy(1, slot, v.to(cache["cached_value"].dtype))
        cache["cached_key"] = cached_k
        cache["cached_value"] = cached_v
        cache["cache_index"] = i + 1
        if self.window is not None:
            span = min(self.window, max_len)
            start = torch.clamp(i - span + 1, min=0, max=max_len - span)
            rows = start.to(torch.int64) + torch.arange(span, device=q.device)
            k_ctx = cached_k.index_select(1, rows)
            v_ctx = cached_v.index_select(1, rows)
        else:
            start = 0
            k_ctx, v_ctx = cached_k, cached_v
        # GQA: the cache stays kv_heads wide; broadcast only here.
        k_ctx, v_ctx = self._expand_kv(k_ctx), self._expand_kv(v_ctx)
        return flash_lib.reference_attention(
            q.float(), k_ctx.float(), v_ctx.float(), causal=True,
            q_offset=i, k_offset=start, window=self.window,
        ).to(q.dtype)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + MHA(LN(x)); x + FFN(LN(x)). The FFN is dense
    with the tanh-approximated GELU (flax nn.gelu's default), or with
    `num_experts > 1` the MoE (a submodule named `moe`). Returns
    (y, aux_loss): the router's aux loss, None for a dense block."""

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
        num_selected_experts: int = 2,
        decode: bool = False,
        decode_max_len: int = 2048,
        mesh: Optional[object] = None,
        sequence_parallel_mode: str = "ring",
        manual_sequence_size: int = 1,
    ):
        super().__init__()
        self.attention = MultiHeadAttention(
            features, num_heads, head_dim, causal=causal, use_flash=use_flash,
            window=window, num_kv_heads=num_kv_heads, decode=decode,
            decode_max_len=decode_max_len, mesh=mesh,
            sequence_parallel_mode=sequence_parallel_mode,
            manual_sequence_size=manual_sequence_size,
        )
        self.ln_attn = nn.LayerNorm(features, eps=LAYER_NORM_EPS)
        self.ln_mlp = nn.LayerNorm(features, eps=LAYER_NORM_EPS)
        if num_experts > 1:
            self.moe = MoEBlock(
                features, num_experts, mlp_ratio * features,
                num_selected=num_selected_experts, mesh=mesh,
            )
        else:
            self.mlp_in = nn.Linear(features, mlp_ratio * features)
            self.mlp_out = nn.Linear(mlp_ratio * features, features)

    def forward(
        self, x: torch.Tensor, cache: Optional[DecodeCache] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        attention_cache = None if cache is None else cache.child("attention")
        x = x + self.attention(self.ln_attn(x), attention_cache)
        h = self.ln_mlp(x)
        if hasattr(self, "moe"):
            h, aux_loss = self.moe(h)
        else:
            h = F.gelu(self.mlp_in(h), approximate="tanh")
            h, aux_loss = self.mlp_out(h), None
        return x + h, aux_loss


class PipelineStage(nn.Module):
    """The repeating unit of the pipelined encoder: a run of pre-norm
    blocks `block_0..block_<n-1>`, each a remat segment. Attention inside
    follows the single-device policy, or with `sequence_axis_size` > 1 the
    manual ring or Ulysses (`sequence_parallel_mode`) over the mesh's
    sequence dim: the stage then runs on this rank's sequence shard."""

    def __init__(
        self,
        num_blocks: int,
        features: int,
        num_heads: int,
        head_dim: int,
        mlp_ratio: int = 4,
        causal: bool = True,
        use_flash: Optional[bool] = None,
        window: Optional[int] = None,
        num_kv_heads: Optional[int] = None,
        mesh: Optional[object] = None,
        sequence_axis_size: int = 1,
        sequence_parallel_mode: str = "ring",
    ):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(
                f"block_{i}",
                TransformerBlock(
                    features, num_heads, head_dim, mlp_ratio=mlp_ratio,
                    causal=causal, use_flash=use_flash, window=window,
                    num_kv_heads=num_kv_heads,
                    mesh=mesh if sequence_axis_size > 1 else None,
                    sequence_parallel_mode=sequence_parallel_mode,
                    manual_sequence_size=sequence_axis_size,
                ),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            x, _ = remat.segment(getattr(self, f"block_{i}"), x)
        return x


# A chain block's state entry, relative to the encoder: (index, the rest).
_BLOCK_ENTRY = re.compile(r"^block_(\d+)\.(.+)$")


class TransformerEncoder(nn.Module):
    """N pre-norm blocks with learned positional embeddings over
    [batch, seq, features]; final LayerNorm. Each block is a remat
    segment (layers/remat.py). Returns (y, aux_losses): the aux loss of
    every MoE block ([] without experts).

    decode: one step per call; the encoder's own counter `position`
    picks the positional row (clamped to the last past capacity), and
    the blocks decode against caches of max_seq_len slots.

    mesh: with a `sequence` dim above 1 the blocks run on this rank's
    sequence shard and the output is all_gathered back (module
    docstring); `sequence_parallel_mode` picks ring or Ulysses.

    pipeline_stages: above 1, this rank's stage of the blocks runs in the
    GPipe schedule over the mesh's pipe dim (module docstring), in
    `pipeline_microbatches` microbatches (None: the largest divisor of
    the local batch up to 2 x pipeline_stages, JAX's default).
    """

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
        num_selected_experts: int = 2,
        decode: bool = False,
        mesh: Optional[object] = None,
        pipeline_stages: int = 1,
        pipeline_microbatches: Optional[int] = None,
        sequence_parallel_mode: str = "ring",
    ):
        super().__init__()
        _check_pipeline(num_layers, pipeline_stages, num_experts, mesh,
                        sequence_parallel_mode, num_heads, decode)
        _check_mesh(mesh, sequence_parallel_mode, decode=decode)
        self.max_seq_len = max_seq_len
        self.decode = decode
        self.mesh = mesh
        self.pipeline_stages = pipeline_stages
        self.pipeline_microbatches = pipeline_microbatches
        self.pos_embedding = nn.Parameter(torch.zeros(max_seq_len, features))
        self.num_layers = num_layers
        if pipeline_stages > 1:
            # Only this rank's stage: pipelining exists to save the rest.
            self.stage = collectives.axis_index(mesh, mesh_lib.PIPE_AXIS)
            self.add_module(mesh_lib.PIPE_STAGES_KEY, PipelineStage(
                num_layers // pipeline_stages, features, num_heads, head_dim,
                mlp_ratio=mlp_ratio, causal=causal, use_flash=use_flash,
                window=window, num_kv_heads=num_kv_heads, mesh=mesh,
                sequence_axis_size=_sequence_size(mesh),
                sequence_parallel_mode=sequence_parallel_mode,
            ))
            self._register_load_state_dict_pre_hook(self._stage_entries)
        else:
            for i in range(num_layers):
                self.add_module(
                    f"block_{i}",
                    TransformerBlock(
                        features, num_heads, head_dim, mlp_ratio=mlp_ratio,
                        causal=causal, use_flash=use_flash, window=window,
                        num_kv_heads=num_kv_heads, num_experts=num_experts,
                        num_selected_experts=num_selected_experts, decode=decode,
                        decode_max_len=max_seq_len, mesh=mesh,
                        sequence_parallel_mode=sequence_parallel_mode,
                    ),
                )
            self._register_load_state_dict_pre_hook(self._chain_entries)
        self.ln_final = nn.LayerNorm(features, eps=LAYER_NORM_EPS)

    def _stage_entries(self, state_dict, prefix, *args) -> None:
        """load_state_dict's pre-hook of a pipelined encoder: a stacked
        [S, ...] stage entry becomes this rank's slice, and a chain entry
        `block_<i>` of this stage's blocks its `pipe_stages.block_<b>`
        (another stage's block is dropped: its rank loads it)."""
        stage = getattr(self, mesh_lib.PIPE_STAGES_KEY)
        own = {k: v.ndim for k, v in stage.state_dict().items()}
        stage_prefix = f"{prefix}{mesh_lib.PIPE_STAGES_KEY}."
        first = self.stage * stage.num_blocks
        for key in list(state_dict):
            if key.startswith(stage_prefix):
                rest = key[len(stage_prefix):]
                if rest in own and state_dict[key].ndim == own[rest] + 1:
                    state_dict[key] = state_dict[key][self.stage]
                continue
            match = _BLOCK_ENTRY.match(key[len(prefix):]) if key.startswith(prefix) else None
            if match is None or int(match[1]) >= self.num_layers:
                continue
            value = state_dict.pop(key)
            if first <= int(match[1]) < first + stage.num_blocks:
                state_dict[f"{stage_prefix}block_{int(match[1]) - first}.{match[2]}"] = value

    def _chain_entries(self, state_dict, prefix, *args) -> None:
        """load_state_dict's pre-hook of a plain encoder: the stacked stage
        entries of a pipelined one (`pipe_stages.block_<b>.*`, [S, ...])
        become the chain's blocks, stage s's block b as block s * L/S + b
        (pipeline.unstack_stages)."""
        stage_prefix = f"{prefix}{mesh_lib.PIPE_STAGES_KEY}.block_"
        keys = [key for key in state_dict if key.startswith(stage_prefix)]
        if not keys:
            return
        own = {k: v.ndim for k, v in self.block_0.state_dict().items()}
        stacked = {}
        for key in keys:
            rest = key[len(stage_prefix):].partition(".")[2]
            # Only the stacked layout; anything else is left unexpected.
            if state_dict[key].ndim == own.get(rest, -1) + 1:
                stacked[key[len(prefix):]] = state_dict.pop(key)
        for key, value in pipeline.unstack_stages(stacked).items():
            state_dict[prefix + key] = value

    def init_own_parameters(self, generator: torch.Generator) -> None:
        """flax's normal(0.02) initializer for the position table."""
        with torch.no_grad():
            nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)

    def init_cache(
        self, batch: int, cache: DecodeCache, dtype: torch.dtype,
        device: torch.device,
    ) -> None:
        """Writes the zeroed position counter and every block's K/V cache."""
        cache["position"] = torch.zeros((), dtype=torch.int32, device=device)
        for i in range(self.num_layers):
            getattr(self, f"block_{i}").attention.init_cache(
                batch, cache.child(f"block_{i}").child("attention"), dtype,
                device,
            )

    def forward(
        self, x: torch.Tensor, cache: Optional[DecodeCache] = None
    ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        _check_decode(self.decode, cache)
        seq = x.shape[1]
        if seq > self.max_seq_len:
            raise ValueError(
                f"sequence length {seq} exceeds max_seq_len={self.max_seq_len}"
            )
        if self.decode:
            position = cache["position"]
            row = torch.clamp(position, max=self.max_seq_len - 1)
            x = x + self.pos_embedding.index_select(
                0, row.to(torch.int64).reshape(1)
            )[None]
            cache["position"] = position + 1
        else:
            x = x + self.pos_embedding[None, :seq]
        shards = _sequence_size(self.mesh)
        if shards > 1:
            if seq % shards:
                if self.pipeline_stages > 1:
                    raise ValueError(
                        f"sequence length {seq} not divisible by the "
                        f"sequence axis size {shards}"
                    )
                raise ValueError(
                    f"sequence length {seq} must be divisible by the "
                    f"'sequence' axis size {shards}"
                )
            block = seq // shards
            me = collectives.axis_index(self.mesh, mesh_lib.SEQUENCE_AXIS)
            x = x[:, me * block:(me + 1) * block]
        aux_losses = []
        if self.pipeline_stages > 1:
            x = self._pipelined_blocks(x)
        else:
            for i in range(self.num_layers):
                block = getattr(self, f"block_{i}")
                if self.decode:
                    x, aux_loss = block(x, cache.child(f"block_{i}"))
                else:
                    x, aux_loss = remat.segment(block, x)
                if aux_loss is not None:
                    aux_losses.append(aux_loss)
        x = self.ln_final(x)
        if shards > 1:
            x = collectives.all_gather(x, self.mesh, mesh_lib.SEQUENCE_AXIS, axis=1)
        return x, aux_losses

    def _pipelined_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's stage in the GPipe schedule over the pipe dim, on
        its batch shard (and sequence shard)."""
        shape = mesh_lib.mesh_shape(self.mesh)
        batch_axes = tuple(a for a in (mesh_lib.DATA_AXIS, mesh_lib.FSDP_AXIS)
                           if shape[a] > 1)
        shards = shape[mesh_lib.DATA_AXIS] * shape[mesh_lib.FSDP_AXIS]
        if self.pipeline_microbatches is not None:
            micro = self.pipeline_microbatches
            if (x.shape[0] * shards) % micro != 0:
                raise ValueError(
                    f"batch {x.shape[0] * shards} not divisible by "
                    f"pipeline_microbatches={micro}"
                )
        else:
            # JAX's default: the largest divisor of the shard's batch up to
            # 2 x S (~33% bubble in JAX's schedule).
            limit = x.shape[0]
            micro = max(d for d in range(1, min(limit, 2 * self.pipeline_stages) + 1)
                        if limit % d == 0)
        stage = getattr(self, mesh_lib.PIPE_STAGES_KEY)
        return pipeline.pipeline_apply(
            lambda params, h: stage(h), list(stage.parameters()), x,
            mesh=self.mesh, num_microbatches=micro,
            batch_axis=(batch_axes[0] if len(batch_axes) == 1
                        else batch_axes or None),
            sequence_axis=(mesh_lib.SEQUENCE_AXIS
                           if shape[mesh_lib.SEQUENCE_AXIS] > 1 else None),
        )
