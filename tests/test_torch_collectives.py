"""Port parity: parallel/mesh.py and parallel/collectives.py against the
JAX package's mesh and collectives.

The JAX side runs each collective under shard_map on the conftest's
8-device CPU mesh (`make_mesh(data=1, sequence=4, devices=jax.devices()[:4])`,
the default vma checking) and differentiates it with jax.vjp; the port's
side runs the same blocks on 4 gloo ranks (one LocalWorld for the module,
every case in it) and backpropagates through each collective's autograd
rule. Inputs come from a numpy seed; f32 sums over 4 ranks in another
order, so the tolerance is 1e-6.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tensor2robot_tpu.parallel import collectives as jax_collectives
from tensor2robot_tpu.parallel import mesh as jax_mesh_lib
from tensor2robot_tpu_torch.parallel import collectives, launch
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tests import torch_parallel_ranks as ranks

TOL = 1e-6
SEQ = "sequence"


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(4, threads=1) as w:
        yield w


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_mesh_lib.make_mesh(data=1, sequence=4, devices=jax.devices()[:4])


JAX_BODIES = {
    "psum": lambda x: jax_collectives.psum(x, SEQ),
    "pmean": lambda x: jax_collectives.pmean(x, SEQ),
    "ppermute": lambda x, perm: jax_collectives.ppermute(x, SEQ, perm),
    "all_to_all": lambda x, split_axis, concat_axis: jax_collectives.all_to_all(
        x, SEQ, split_axis, concat_axis, tiled=True),
    "all_gather": lambda x, axis: jax_collectives.all_gather(x, SEQ, axis=axis, tiled=True),
    "psum_scatter": lambda x, axis: jax_collectives.psum_scatter(
        x, SEQ, scatter_dimension=axis, tiled=True),
}
# (op, kwargs, output replicated over the ranks)
CASES = {
    "psum": ("psum", {}, True),
    "pmean": ("pmean", {}, True),
    "ppermute_ring": ("ppermute", dict(perm=[(j, (j + 1) % 4) for j in range(4)]), False),
    "ppermute_partial": ("ppermute", dict(perm=[(0, 2), (1, 3)]), False),
    "all_to_all_1_0": ("all_to_all", dict(split_axis=1, concat_axis=0), False),
    "all_to_all_2_1": ("all_to_all", dict(split_axis=2, concat_axis=1), False),
    "all_gather_1": ("all_gather", dict(axis=1), False),
    "psum_scatter_1": ("psum_scatter", dict(axis=1), False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_collective_and_its_gradient_match_jax(world, jax_mesh, case):
    op, kwargs, replicated = CASES[case]
    rng = np.random.RandomState(len(case))
    x = rng.randn(16, 8, 4).astype(np.float32)
    fn = jax_collectives.shard_map(
        lambda t: JAX_BODIES[op](t, **kwargs), mesh=jax_mesh,
        in_specs=(P(SEQ),), out_specs=P() if replicated else P(SEQ),
    )
    expected, vjp = jax.vjp(jax.jit(fn), x)
    g = rng.randn(*expected.shape).astype(np.float32)
    (expected_dx,) = vjp(g)
    results = world.run(ranks.collective, op, x, g, replicated, kwargs)
    outs = [out for out, _ in results]
    if replicated:
        for out in outs:
            np.testing.assert_allclose(out, np.asarray(expected), rtol=TOL, atol=TOL)
    else:
        np.testing.assert_allclose(np.concatenate(outs), np.asarray(expected),
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.concatenate([dx for _, dx in results]),
                               np.asarray(expected_dx), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)], ids=str)
def test_mesh_dims_and_axis_index_match_jax(world, shape):
    data, sequence = shape
    facts = world.run(ranks.mesh_facts, data, sequence)
    devices = jax.devices()[:4]
    jax_mesh = jax_mesh_lib.make_mesh(data=data, sequence=sequence, devices=devices)
    assert all(f["shape"] == dict(jax_mesh.shape) for f in facts)
    # Rank r is the r-th device of jax.devices() order in the JAX mesh.
    for f in facts:
        where = np.argwhere(jax_mesh.devices == devices[f["rank"]])[0]
        coords = dict(zip(jax_mesh.axis_names, where))
        assert (f["data"], f["sequence"]) == (coords["data"], coords["sequence"])
        assert f["data_shard"] == (coords["data"], data)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)], ids=str)
def test_shard_batch_takes_the_jax_shard_of_this_rank(world, shape):
    """A rank's slice of a batch (shard_batch) is the shard its JAX device
    holds; a leaf whose batch dim does not divide is kept whole (JAX
    replicates it)."""
    data, sequence = shape
    rng = np.random.RandomState(0)
    batch = TensorSpecStruct()
    batch["features/image"] = rng.randn(4, 6, 3).astype(np.float32)
    batch["features/odd"] = rng.randn(3, 2).astype(np.float32)
    devices = jax.devices()[:4]
    jax_mesh = jax_mesh_lib.make_mesh(data=data, sequence=sequence, devices=devices)
    placed = jax_mesh_lib.shard_batch(dict(batch.items()), jax_mesh)
    for rank, local in enumerate(world.run(ranks.shard, batch, data, sequence)):
        for key, leaf in local.items():
            shard = next(s for s in placed[key].addressable_shards
                         if s.device == devices[rank])
            np.testing.assert_array_equal(leaf, np.asarray(shard.data))


def test_axis_index_matches_jax(world, jax_mesh):
    fn = jax_collectives.shard_map(
        lambda t: t * 0 + jax_collectives.axis_index(SEQ), mesh=jax_mesh,
        in_specs=(P(SEQ),), out_specs=P(SEQ),
    )
    expected = np.asarray(jax.jit(fn)(np.zeros(4, np.int32)))
    facts = world.run(ranks.mesh_facts, 1, 4)
    assert [f["sequence"] for f in facts] == expected.tolist()


def test_make_mesh_errors_and_the_world_of_one():
    """Outside a process group: a mesh of one rank over an in-process group
    (checked in a subprocess, which owns its group), and the divisibility
    errors of the JAX make_mesh for more ranks than the world has."""
    import subprocess
    import sys

    script = (
        "from tensor2robot_tpu_torch.parallel import mesh as m\n"
        "try:\n    m.make_mesh(sequence=2)\nexcept ValueError as e:\n    print('E1', e)\n"
        "mesh = m.make_mesh()\n"
        "print(m.mesh_shape(mesh))\n"
        "try:\n    m.make_mesh(data=2)\nexcept ValueError as e:\n    print('E2', e)\n"
        "try:\n    m.make_mesh(sequence=3)\nexcept ValueError as e:\n    print('E3', e)\n"
        "m.initialize_distributed(world_size=1)\n"
    )
    result = subprocess.run([sys.executable, "-c", script], capture_output=True,
                            text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-2000:]
    out = result.stdout
    assert "E1 a mesh of more than one rank needs the process group" in out
    assert "{'data': 1, 'fsdp': 1, 'model': 1, 'sequence': 1, 'pipe': 1, 'expert': 1}" in out
    assert "E2 Mesh 2x1x1x1x1x1 != 1 devices" in out
    assert "E3 1 devices not divisible by fsdp*model*sequence*pipe*expert=3" in out


def test_mesh_type_and_unported_rules():
    with pytest.raises(TypeError, match="DeviceMesh"):
        mesh_lib.check_mesh(object())
    # Parameter sharding is ported (A9.4b) and so is the ZeRO-2 rule
    # (A9.4a): without a mesh (fsdp, model and the replica group all 1)
    # neither shards anything (tests/test_torch_sharded_params.py holds
    # the rule against JAX's on meshes).
    assert mesh_lib.param_sharding(None)("w.weight", torch.zeros(256, 256)) == (None, None)
    assert mesh_lib.weight_update_sharding(None)(torch.zeros(256, 256)) is None
    # pipe_stage_param_rule is ported: without a pipe dim above 1 nothing
    # is stage-local (tests/test_torch_pipelined_bc.py holds it on a mesh).
    rule = mesh_lib.pipe_stage_param_rule(None)
    assert rule("encoder.pipe_stages.block_0.attention.qkv.weight") is None
    assert mesh_lib.is_stage_entry("encoder/pipe_stages/block_0/attention/qkv/kernel")
    assert not mesh_lib.is_stage_entry("encoder.block_0.attention.qkv.weight")
    # The codecs are ported (A9.4a): the registry resolves, and a name
    # outside it raises KeyError naming both flags and the menu.
    assert collectives.available_collectives() == (
        "fp16", "fp8_e4m3", "fp8_e5m2", "int8", "none")
    assert collectives.get_collective("int8", 512).wire_bytes(1024) == 1024 + 8
    with pytest.raises(KeyError, match="T2R_COLLECTIVE_QUANT"):
        collectives.get_collective("int4", 512)
