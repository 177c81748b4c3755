"""Port parity: the ZeRO-2 gradient codecs, the weight-update rule and the
flags, on one process.

For every codec, on seeded numpy vectors (unit scale, 1e4 and 1e-30, a
zero block among them): the port's `encode` gives JAX's `{"q", "s"}`
payload bit for bit (q compared as bytes, s as f32) and `decode` gives
JAX's bit for bit. Then the behaviour tests/test_collectives.py pins on
the JAX side: the round trip within half a quantization step, zero blocks,
the fp8 clip before the cast, wire_bytes, FlatShardLayout's padding and
its bad inputs, wire_summary's ratios and get_collective's message; the
weight-update rule against JAX's on the same shapes, collective_record's
keys, and the two flags' declarations. A few seconds on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu import flags as jax_flags
from tensor2robot_tpu.parallel import collectives as jax_collectives
from tensor2robot_tpu.train.metrics import collective_record as jax_collective_record
from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.train.metrics import collective_record

BLOCK = 64
N, L = 8, 4 * BLOCK
STEP_FACTORS = {"fp16": 2.0 ** -10, "int8": 1 / 127.0, "fp8_e4m3": 2.0 ** -3,
                "fp8_e5m2": 2.0 ** -2}
QUANT = sorted(STEP_FACTORS)


def _rows(seed: int, scale: float = 1.0) -> np.ndarray:
    rows = (np.random.RandomState(seed).randn(N, L) * scale).astype(np.float32)
    rows[1, :BLOCK] = 0.0  # a zero block
    return rows


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy().tobytes()
    return np.asarray(t).tobytes()


@pytest.mark.parametrize("scale", [1.0, 1e4, 1e-30])
@pytest.mark.parametrize("name", ["none"] + QUANT)
def test_payloads_match_jax_bit_for_bit(name, scale):
    x = _rows(0, scale)
    ours = collectives.get_collective(name, BLOCK)
    theirs = jax_collectives.get_collective(name, BLOCK)
    got, want = ours.encode(torch.from_numpy(x)), theirs.encode(jnp.asarray(x))
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape)
        assert got[key].element_size() == np.asarray(want[key]).dtype.itemsize
        assert _bytes(got[key]) == _bytes(want[key]), key
    assert _bytes(ours.decode(got)) == _bytes(theirs.decode(want))


@pytest.mark.parametrize("name", QUANT)
def test_round_trip_within_half_a_step(name):
    coll = collectives.get_collective(name, BLOCK)
    x = _rows(3)
    decoded = coll.decode(coll.encode(torch.from_numpy(x))).numpy()
    blocks = x.reshape(N, L // BLOCK, BLOCK)
    step = np.abs(blocks).max(axis=-1, keepdims=True) * STEP_FACTORS[name]
    err = np.abs(decoded.reshape(blocks.shape) - blocks)
    assert (err <= step * 0.5 * (1 + 1e-6) + 1e-12).all()


@pytest.mark.parametrize("name", ["fp8_e4m3", "fp8_e5m2"])
def test_fp8_clips_before_the_cast(name):
    """Each block's max maps to the format's max: a rounding past it must
    be clipped, not cast (an overflow would decode as NaN)."""
    coll = collectives.get_collective(name, BLOCK)
    payload = coll.encode(torch.from_numpy(_rows(5, scale=1e4)))
    assert payload["q"].element_size() == 1
    assert torch.isfinite(coll.decode(payload)).all()
    assert payload["q"].float().abs().max() == coll._MAX
    assert coll.wire_bytes(1 << 20) == (1 << 20) + 4 * ((1 << 20) // BLOCK)


def test_zero_blocks_and_block_divisibility():
    coll = collectives.get_collective("int8", BLOCK)
    payload = coll.encode(torch.zeros(2, L))
    assert torch.equal(payload["s"], torch.full((2, L // BLOCK), 1 / 127.0))
    assert torch.equal(coll.decode(payload), torch.zeros(2, L))
    with pytest.raises(ValueError, match="not divisible"):
        coll.encode(torch.zeros(BLOCK + 1))


def test_get_collective_names_its_flags_and_the_menu(monkeypatch):
    with pytest.raises(KeyError) as err:
        collectives.get_collective("int4", BLOCK)
    message = str(err.value)
    for word in ("unknown collective", "T2R_COLLECTIVE_QUANT", "T2R_COLLECTIVE_BLOCK",
                 *collectives.available_collectives()):
        assert word in message
    assert collectives.available_collectives() == jax_collectives.available_collectives()
    with pytest.raises(ValueError, match="twice"):
        collectives.register_collective("int8")(lambda block: None)
    monkeypatch.setenv("T2R_COLLECTIVE_QUANT", "fp16")
    monkeypatch.setenv("T2R_COLLECTIVE_BLOCK", "0")
    coll = collectives.get_collective()
    assert (coll.name, coll.block) == ("fp16", 1)  # the block's minimum is 1


def test_flags_match_jax():
    for name in ("T2R_COLLECTIVE_QUANT", "T2R_COLLECTIVE_BLOCK"):
        ours, theirs = flags.get_flag(name), jax_flags.get_flag(name)
        assert (ours.kind, ours.default, ours.choices, ours.minimum) == (
            theirs.kind, theirs.default, theirs.choices, theirs.minimum)


def test_flat_shard_layout():
    layout = collectives.FlatShardLayout(1000, 8, 64)
    theirs = jax_collectives.FlatShardLayout(1000, 8, 64)
    assert (layout.shard_len, layout.padded) == (theirs.shard_len, theirs.padded) == (128, 1024)
    flat = torch.arange(1000, dtype=torch.float32)
    padded = layout.pad(flat)
    assert padded.shape == (1024,) and not padded[1000:].any()
    assert torch.equal(layout.unpad(padded), flat)
    assert layout.rows(padded).shape == (8, 128)
    with pytest.raises(ValueError):
        collectives.FlatShardLayout(0, 8, 64)
    with pytest.raises(ValueError, match="bad layout"):
        collectives.FlatShardLayout(10, 0, 64)
    with pytest.raises(ValueError, match="expected"):
        collectives.FlatShardLayout(100, 4, 8).pad(torch.zeros(101))


@pytest.mark.parametrize("name", ["none"] + QUANT)
def test_wire_summary_matches_jax(name):
    n = 1 << 20
    pre, post = collectives.wire_summary(collectives.get_collective(name, 512), n)
    assert (pre, post) == jax_collectives.wire_summary(
        jax_collectives.get_collective(name, 512), n)
    ratio = {"none": 1.0, "fp16": 1.9}.get(name, 3.5)
    assert pre / post >= ratio


def test_collective_record_matches_jax():
    assert collective_record(800, 200, 1.5) == jax_collective_record(800, 200, 1.5)
    assert collective_record(800, 200) == jax_collective_record(800, 200)


@pytest.mark.parametrize("shape", [(3, 100), (100, 100), (4096, 7), (7, 4096, 3), (100,),
                                   (6, 6), (20000,), (16384,), (16383,), ()])
def test_weight_update_rule_matches_jax(shape, monkeypatch):
    """The dim the rule picks for a 4-rank data group, where JAX's
    PartitionSpec puts "data" on the same shape (the port's torch layouts
    differ from flax's; the rule does not)."""
    import jax
    from tensor2robot_tpu.parallel import mesh as jax_mesh_lib

    jax_mesh = jax_mesh_lib.make_mesh(data=4, devices=jax.devices()[:4])
    spec = jax_mesh_lib.weight_update_sharding(jax_mesh)(np.zeros(shape)).spec
    want = next((i for i, entry in enumerate(spec) if entry == "data"), None)
    assert mesh_lib.weight_update_sharding(None)(torch.zeros(shape)) is None
    four = dict(mesh_lib.mesh_shape(None), data=4)  # what the rule reads of a mesh
    monkeypatch.setattr(mesh_lib, "mesh_shape", lambda mesh: four)
    assert mesh_lib.weight_update_sharding(object())(torch.zeros(shape)) == want
