"""Parallelism over the device mesh: dims, collectives, sequence parallelism.

Port of tensor2robot_tpu/parallel/, one process per rank (parallel/mesh.py).
Six named mesh dims, as in the JAX package: data and fsdp (the batch),
model, sequence (ring or Ulysses attention), pipe and expert. Ported: the
mesh, the collectives, ring and Ulysses attention and the trainer's data x
sequence regime. Pipelining, expert parallelism, the ZeRO-2 codecs and the
planner are not (ROADMAP.md A9).
"""

from tensor2robot_tpu_torch.parallel.mesh import (
    AXES,
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQUENCE_AXIS,
    initialize_distributed,
    make_mesh,
    param_sharding,
    shard_batch,
)

# NOTE: ring_attention is NOT re-exported as a function here — the package
# attribute `parallel.ring_attention` must stay the submodule (callers use
# `from tensor2robot_tpu_torch.parallel import ring_attention` then
# `ring_attention.ring_attention(...)`).
