"""Parallelism over the device mesh: dims, collectives, sequence
parallelism, pipelining, parameter sharding.

Port of tensor2robot_tpu/parallel/, one process per rank (parallel/mesh.py).
Six named mesh dims, as in the JAX package: data and fsdp (the batch),
model, sequence (ring or Ulysses attention), pipe (GPipe stages,
parallel/pipeline.py) and expert. Ported: the mesh, the collectives, ring
and Ulysses attention, the GPipe schedule, and the trainer's data x fsdp
x sequence x pipe x expert regime: global-batch steps over data x fsdp
shards (synchronized batch-norm moments, per-shard draws, shard_by_host
input, exporters, hooks and continuous eval on rank 0's single-device
model), experts computed by their resident expert rank, and a pipelined
encoder's stages held by their pipe ranks (stacked in the checkpoint);
ZeRO-2 over the product of any replica dims (weight_update_axes), the
block-scaled gradient codecs and the trainer's exact and quantized
regimes; the sharded_params regime over fsdp and model
(parallel/sharded_params.py: mesh.param_sharding's ZeRO-3 and Megatron
column split); each of them, and the flat optimizer update, composed
with the sequence, pipe and expert dims (a pipeline's stage entries whole
on their stage, as JAX's stage rule places them), with clipping by a
global norm across shards and stages; experts under a sequence dim (each
block's MoE gathers the episode's shards), MAML on sharded parameters
(gathered whole before the inner loop), and decoding over a mesh whose
sequence dim is 1; the sharding planner (planner.py: its analytic and
measured search, presets, plans driving the trainer and the audit of
their layouts) with its plan cache (plan_cache.py). Not ported: splitting
attention heads over the model dim (ROADMAP.md A9.4c, a layout choice).
"""

from tensor2robot_tpu_torch.parallel.mesh import (
    AXES,
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    PIPE_STAGES_KEY,
    MIN_WEIGHT_SIZE,
    SEQUENCE_AXIS,
    complement,
    dims_group,
    initialize_distributed,
    make_mesh,
    param_dims,
    param_sharding,
    shard_batch,
    weight_update_sharding,
)

# NOTE: ring_attention is NOT re-exported as a function here — the package
# attribute `parallel.ring_attention` must stay the submodule (callers use
# `from tensor2robot_tpu_torch.parallel import ring_attention` then
# `ring_attention.ring_attention(...)`).
