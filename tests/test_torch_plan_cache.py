"""The port's plan cache (parallel/plan_cache.py) and the auto search it
fronts (planner.resolve_plan_from_flag under T2R_PLAN=auto).

As JAX's tests/test_plan_cache.py pins them, on the port's key:

  * the envelope: a round trip, a hit byte-identical to what was stored,
    no file without a directory, a forged length refused before it is
    read, the fingerprint deterministic and sensitive to the model;
  * each corruption variant of a valid entry (truncated at every header
    boundary and mid-payload, a bit flipped in each region, a bad magic,
    a bad CRC, trailing bytes), built here, is a typed PlanCacheCorrupt
    from the strict reader and a None from `load()`;
  * each key component differing (fingerprint, world size, device name,
    compute capability, torch version, schema version) is a typed
    PlanCacheKeyMismatch and a None from `load()`;
  * in one process: an analytic auto search is stored and the next one
    hits the cache with the same plan; a corrupt or mismatched entry
    forces a fresh search, which repairs it;
  * on a LocalWorld of 4 gloo ranks: a cold shortlist-2 search measures
    (one probe or more: the pipelined candidate the model cannot run is
    skipped), a warm one hits the cache with 0 probes, and every rank
    holds the same plan document, which then drives a trainer whose audit
    is clean; train_eval_model under T2R_PLAN=auto searches, trains on
    the winner and, run again, reads the plan from the cache.

The module runs in about 15 s on the CPU, a third of it the ranks' start.
"""

import os
import struct

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.data.input_generators import DefaultRandomInputGenerator
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.parallel import launch
from tensor2robot_tpu_torch.parallel import plan_cache, planner
from tests import torch_plan_ranks as ranks

SMALL = dict(action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
             d_model=32, num_layers=2, num_heads=4, head_dim=8)
N = 8
_TOPOLOGY = {"platform": "cpu", "device_name": "cpu", "compute_capability": None,
             "world_size": N}
_AUTO = ("T2R_PLAN", "T2R_PLAN_CACHE_DIR", "T2R_PLAN_MEASURE", "T2R_PLAN_MEASURE_STEPS")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def model_and_batch():
    model = TransformerBCModel(device_type="cpu", **SMALL)
    generator = DefaultRandomInputGenerator(batch_size=8, seed=0)
    generator.set_specification_from_model(model, "train")
    return model, next(iter(generator.create_dataset("train")))


@pytest.fixture(scope="module")
def spec(model_and_batch):
    return planner.ModelSpec.from_model(*model_and_batch)


def _payload_doc(spec):
    result = planner.plan(spec, planner.Topology(num_devices=N))
    return {"plan": result.best.to_json(), "table": list(result.table)}


def _corrupt_variants(blob: bytes) -> dict:
    """Every corruption of a valid envelope the reader must refuse."""
    rest = len(blob) - 12

    def flip(at: int) -> bytes:
        return blob[:at] + bytes([blob[at] ^ 0x01]) + blob[at + 1:]

    out = {f"truncated_{n}": blob[:n] for n in (0, 3, 4, 8, 11, 12, 16, len(blob) // 2,
                                                 len(blob) - 1)}
    out.update(bad_magic=b"T2RX" + blob[4:], bad_crc=blob[:8] + struct.pack(
        "<I", (struct.unpack("<I", blob[8:12])[0] + 1) & 0xFFFFFFFF) + blob[12:],
        trailing=blob + b"\x00", short_length=blob[:4] + struct.pack("<I", rest - 1) + blob[8:],
        long_length=blob[:4] + struct.pack("<I", rest + 1) + blob[8:],
        flipped_magic=flip(0), flipped_length=flip(5), flipped_crc=flip(9),
        flipped_header_length=flip(13),
        flipped_header=flip(20), flipped_payload=flip(len(blob) - 2))
    return out


def test_pack_unpack_roundtrip(spec):
    doc = _payload_doc(spec)
    blob = plan_cache.pack_entry("f" * 64, doc, topology=_TOPOLOGY)
    header, payload = plan_cache.unpack_entry(blob, expect_fingerprint="f" * 64,
                                              expect_topology=_TOPOLOGY)
    assert header["format_version"] == plan_cache.PLAN_CACHE_FORMAT_VERSION
    assert header["torch"] == torch.__version__
    assert payload == doc
    assert planner.ShardingPlan.from_json(payload["plan"]).to_json() == doc["plan"]


def test_store_load_hit_is_byte_identical(spec, tmp_path):
    fingerprint = plan_cache.model_fingerprint(spec)
    doc = _payload_doc(spec)
    path = plan_cache.store(fingerprint, doc, str(tmp_path))
    assert path and os.path.exists(path)
    payload = plan_cache.load(fingerprint, str(tmp_path))
    assert payload == doc


def test_store_disabled_without_directory(monkeypatch):
    monkeypatch.delenv("T2R_PLAN_CACHE_DIR", raising=False)
    assert plan_cache.cache_dir() is None
    assert plan_cache.store("f" * 64, {"plan": {}}) is None
    assert plan_cache.load("f" * 64) is None


def test_forged_length_bounded_before_allocation():
    blob = plan_cache.pack_entry("f" * 64, {"plan": {}}, topology=_TOPOLOGY)
    forged = blob[:4] + struct.pack("<I", plan_cache.MAX_PLAN_ENTRY_BYTES + 1) + blob[8:]
    with pytest.raises(plan_cache.PlanCacheCorrupt, match="forged"):
        plan_cache.unpack_entry(forged)


def test_fingerprint_deterministic_and_sensitive(spec, model_and_batch):
    import dataclasses

    fingerprint = plan_cache.model_fingerprint(spec)
    assert fingerprint == plan_cache.model_fingerprint(
        planner.ModelSpec.from_model(*model_and_batch))
    assert plan_cache.model_fingerprint(
        dataclasses.replace(spec, batch_size=2 * spec.batch_size)) != fingerprint
    wider = TransformerBCModel(device_type="cpu", **dict(SMALL, d_model=64))
    assert plan_cache.model_fingerprint(
        planner.ModelSpec.from_model(wider, model_and_batch[1])) != fingerprint


def test_every_corruption_is_typed_and_a_miss(spec, tmp_path):
    fingerprint = plan_cache.model_fingerprint(spec)
    path = plan_cache.store(fingerprint, _payload_doc(spec), str(tmp_path), topology=_TOPOLOGY)
    with open(path, "rb") as f:
        blob = f.read()
    variants = _corrupt_variants(blob)
    assert len(variants) >= 20
    for name, bad in sorted(variants.items()):
        with pytest.raises(plan_cache.PlanCacheCorrupt):
            plan_cache.unpack_entry(bad, expect_fingerprint=fingerprint,
                                    expect_topology=_TOPOLOGY)
        with open(path, "wb") as f:
            f.write(bad)
        assert plan_cache.load(fingerprint, str(tmp_path), topology=_TOPOLOGY) is None, name


@pytest.mark.parametrize("component,match", [
    ("fingerprint", "fingerprint"), ("world_size", "topology"), ("device_name", "topology"),
    ("compute_capability", "topology"), ("torch", "torch"), ("schema", "schema")])
def test_key_mismatch_is_typed_and_a_miss(spec, tmp_path, component, match):
    fingerprint = plan_cache.model_fingerprint(spec)
    topology, kwargs, expect = dict(_TOPOLOGY), {}, fingerprint
    if component == "fingerprint":
        expect = "0" * 64
    elif component == "torch":
        kwargs["torch_version"] = "0.0.0-other"
    elif component == "schema":
        kwargs["format_version"] = plan_cache.PLAN_CACHE_FORMAT_VERSION + 1
    else:
        topology[component] = {"world_size": 2 * N, "device_name": "NVIDIA H100 80GB HBM3",
                               "compute_capability": "sm_90"}[component]
    blob = plan_cache.pack_entry(fingerprint, _payload_doc(spec), topology=topology, **kwargs)
    with pytest.raises(plan_cache.PlanCacheKeyMismatch, match=match):
        plan_cache.unpack_entry(blob, expect_fingerprint=expect, expect_topology=_TOPOLOGY)
    with open(plan_cache.entry_path(str(tmp_path), expect), "wb") as f:
        f.write(blob)
    assert plan_cache.load(expect, str(tmp_path), topology=_TOPOLOGY) is None


def test_device_topology_of_this_process():
    topology = plan_cache.device_topology()
    assert topology["world_size"] == 1
    if not torch.cuda.is_available():
        assert topology == {"platform": "cpu", "device_name": "cpu",
                            "compute_capability": None, "world_size": 1}


@pytest.fixture
def auto(monkeypatch, tmp_path):
    for name in _AUTO:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("T2R_PLAN", "auto")
    monkeypatch.setenv("T2R_PLAN_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("T2R_PLAN_MEASURE", "off")
    return str(tmp_path)


def test_analytic_search_is_stored_then_hit(auto, model_and_batch):
    plan = planner.resolve_plan_from_flag(*model_and_batch, device="cpu")
    stats = planner.last_search()
    assert (stats["source"], stats["probe_compiles"], stats["stored"]) == ("analytic", 0, True)
    warm = planner.resolve_plan_from_flag(*model_and_batch, device="cpu")
    assert planner.last_search()["source"] == "cache"
    assert warm.to_json() == plan.to_json()


@pytest.mark.parametrize("damage", ["truncate", "torch"])
def test_damaged_entry_forces_fresh_search(auto, model_and_batch, damage):
    planner.resolve_plan_from_flag(*model_and_batch, device="cpu")
    path = plan_cache.entry_path(auto, planner.last_search()["fingerprint"])
    with open(path, "rb") as f:
        blob = f.read()
    if damage == "truncate":
        blob = blob[: len(blob) // 2]
    else:
        header, payload = plan_cache.unpack_entry(blob)
        blob = plan_cache.pack_entry(header["fingerprint"], payload,
                                     topology=header["topology"], torch_version="0.0.0-other")
    with open(path, "wb") as f:
        f.write(blob)
    planner.resolve_plan_from_flag(*model_and_batch, device="cpu")
    stats = planner.last_search()
    assert stats["source"] == "analytic" and stats["stored"]
    planner.resolve_plan_from_flag(*model_and_batch, device="cpu")
    assert planner.last_search()["source"] == "cache"


def test_flag_gate(monkeypatch, model_and_batch):
    monkeypatch.delenv("T2R_PLAN", raising=False)
    assert planner.resolve_plan_from_flag() is None
    monkeypatch.setenv("T2R_PLAN", "dp_zero2")
    plan = planner.resolve_plan_from_flag()
    assert (plan.name, plan.shard_weight_update, plan.data) == ("dp_zero2", True, 1)
    monkeypatch.setenv("T2R_PLAN", "auto")
    with pytest.raises(ValueError, match="auto"):
        planner.resolve_plan_from_flag()


@pytest.fixture(scope="module")
def world():
    with launch.LocalWorld(4, threads=1) as w:
        yield w


def test_cold_measures_then_warm_probes_nothing_on_every_rank(world, model_and_batch,
                                                              tmp_path):
    batch = {k: np.asarray(v) for k, v in model_and_batch[1].items()}
    results = world.run(ranks.auto_search, SMALL, batch, str(tmp_path))
    for r in results:
        cold, warm = r["cold"]["stats"], r["warm"]["stats"]
        assert cold["source"] == "measured" and cold["probe_compiles"] >= 1
        assert cold["measured"]["shortlist"] == 2
        assert any(m["skipped"] for m in cold["measured"]["measured"])
        assert warm["source"] == "cache" and warm["probe_compiles"] == 0
        assert r["warm"]["plan"] == r["cold"]["plan"] == results[0]["cold"]["plan"]
        assert r["trained_regime"] == planner.ShardingPlan.from_json(
            r["cold"]["plan"]).regime()
    assert len(os.listdir(tmp_path)) == 1


def test_train_eval_model_under_auto(world, tmp_path):
    """T2R_PLAN=auto with no mesh and no plan argument: train_eval_model
    searches with the generator's first batch (measured, the cache
    stored), trains on the winner's mesh and checkpoints; a second run
    to the same step on the same cache reads the plan from it."""
    auto = {"T2R_PLAN": "auto", "T2R_PLAN_CACHE_DIR": str(tmp_path / "cache"),
            "T2R_PLAN_MEASURE": "shortlist-2", "T2R_PLAN_MEASURE_STEPS": "1"}
    cold = world.run(ranks.train_under_flag, SMALL, str(tmp_path / "cold"), auto)
    warm = world.run(ranks.train_under_flag, SMALL, str(tmp_path / "warm"), auto)
    for c, w in zip(cold, warm):
        assert c["search"]["source"] == "measured" and c["search"]["stored"]
        assert w["search"]["source"] == "cache" and w["search"]["probe_compiles"] == 0
        assert c["trainer"] == w["trainer"] == cold[0]["trainer"]
        assert c["trainer"]["plan"] == c["search"]["plan"]
        assert c["step"] == w["step"] == 2
