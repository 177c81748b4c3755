"""export/artifact_store.py: the content-addressed multi-policy store (the
port's twin of tests/test_artifact_store.py), held against the JAX
package's store.

Pinned, case for case with the JAX tests: program blobs dedup by content
hash; sibling weights ship as quantized per-leaf deltas that reconstruct
stable and digest-verified; the per-leaf parity gate demotes
out-of-tolerance leaves to dense-exact (never a partial policy); every
corruption or transplant of the delta envelope is a TYPED refusal through
the public read path, driven by the JAX package's analysis/corpus.py
frame family; gc's mark-and-sweep. Against the JAX store on the same
weights (the mock's network, its state dict in the flax layout through
the export's `flax_variables` table): every delta leaf's quantized values
and scales equal JAX's byte for byte in each codec, the same leaves
demote, and `program_fingerprint` of the same file bytes is JAX's hex.
Finally `exported_policy_loader` boots store policies into servers.
Nothing here builds an AOT package.
"""

import hashlib
import io
import json
import os
import pickle
import time
import types

import numpy as np
import pytest
import torch

from tensor2robot_tpu.analysis import corpus
from tensor2robot_tpu.export import artifact_store as jax_store
from tensor2robot_tpu_torch.export import saved_model
from tensor2robot_tpu_torch.export import serve_quant as sq
from tensor2robot_tpu_torch.export.artifact_store import (
    ArtifactCorrupt,
    ArtifactKeyMismatch,
    ArtifactStore,
    ArtifactStoreError,
    BaseArtifactMissing,
    PolicyExists,
    PolicyNotFound,
    _unpack,
    program_fingerprint,
    weights_digest,
)
from tensor2robot_tpu_torch.export.exporters import LatestExporter
from tensor2robot_tpu_torch.export.saved_model import ExportedModel, latest_export_dir
from tensor2robot_tpu_torch.serving.server import exported_policy_loader
from tensor2robot_tpu_torch.train.train_eval import Trainer
from tensor2robot_tpu_torch.utils import mocks

flax = pytest.importorskip("flax")
from flax import serialization  # noqa: E402

_PROGRAM = b"exported-program-bytes " * 512  # shared across siblings


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "dense0.weight": torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32)),
        "dense0.bias": torch.from_numpy(rng.standard_normal((16,)).astype(np.float32)),
        "step": torch.tensor(7, dtype=torch.int64),
    }


def _perturb(params, seed, scale=1e-3):
    rng = np.random.RandomState(seed)
    return {
        name: (value + torch.from_numpy(
            rng.standard_normal(tuple(value.shape)).astype(np.float32)) * scale
               if value.is_floating_point() else value)
        for name, value in params.items()
    }


def _write_export(dirname, params, program=_PROGRAM, metadata=None):
    os.makedirs(os.path.join(dirname, "program"), exist_ok=True)
    with open(os.path.join(dirname, "program", "predict_fn.pt2"), "wb") as f:
        f.write(program)
    with open(os.path.join(dirname, "t2r_metadata.json"), "w") as f:
        json.dump(metadata or {"test": "artifact_store"}, f)
    torch.save(params, os.path.join(dirname, "variables.pt"))


def _publish(store, tmp_path, policy_id, params, base_policy=None, **kw):
    export_dir = os.path.join(str(tmp_path), f"export-{policy_id}")
    _write_export(export_dir, params)
    return store.put(export_dir, policy_id, base_policy=base_policy, **kw)


def _state(data):
    return torch.load(io.BytesIO(data), weights_only=True)


def _swap_payload_blob(store, policy_id, data):
    """Point `policy_id`'s weights payload at `data`, stored under data's
    OWN content hash: the blob-level sha passes, so the read path
    exercises the envelope checks, not the blob checks."""
    sha = hashlib.sha256(data).hexdigest()
    with open(os.path.join(store.root, "blobs", f"sha256-{sha}"), "wb") as f:
        f.write(data)
    path = os.path.join(store.root, "policies", f"{policy_id}.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["payload"]["blob"] = sha
    manifest["payload"]["nbytes"] = len(data)
    with open(path, "w") as f:
        json.dump(manifest, f)


@pytest.fixture
def store(tmp_path):
    return ArtifactStore(str(tmp_path / "store"))


class TestRoundTrip:
    def test_dense_base_bitwise(self, store, tmp_path):
        params = _params(0)
        manifest = _publish(store, tmp_path, "base", params)
        assert manifest["payload"]["kind"] == "dense"
        with open(os.path.join(str(tmp_path), "export-base", "variables.pt"), "rb") as f:
            assert store.load_weights("base") == f.read()
        restored = _state(store.load_weights("base"))
        assert manifest["payload"]["weights_sha"] == weights_digest(params)
        for name, value in params.items():
            assert torch.equal(restored[name], value), name

    def test_sibling_delta_bitwise_stable_and_within_tolerance(self, store, tmp_path):
        base = _params(0)
        sib = _perturb(base, seed=1)
        _publish(store, tmp_path, "base", base)
        manifest = _publish(store, tmp_path, "sib", sib, base_policy="base", regime="int8")
        payload = manifest["payload"]
        assert payload["kind"] == "delta"
        assert payload["base"] == "base"
        assert payload["leaves"]["delta"] == 2  # weight + bias
        # Stable: two loads, identical bytes, matching the recorded digest.
        first = store.load_weights("sib")
        assert store.load_weights("sib") == first
        restored = _state(first)
        assert weights_digest(restored) == payload["weights_sha"]
        # Within the declared parity tolerance of the ORIGINAL weights.
        for leaf in ("dense0.weight", "dense0.bias"):
            tol = 0.05 * max(float(sib[leaf].abs().max()), 1e-8)
            assert float((restored[leaf] - sib[leaf]).abs().max()) <= tol
        # The non-float leaf ships dense-exact.
        assert torch.equal(restored["step"], sib["step"])
        assert list(restored) == list(sib)  # the state dict's own order

    def test_program_blob_dedup_shrinks_the_store(self, store, tmp_path):
        base = _params(0)
        _publish(store, tmp_path, "base", base)
        for i in range(4):
            _publish(store, tmp_path, f"sib{i}", _perturb(base, seed=10 + i),
                     base_policy="base")
        stats = store.stats()
        assert stats["n_policies"] == 5
        assert stats["n_delta_policies"] == 4
        sha = hashlib.sha256(_PROGRAM).hexdigest()
        assert os.path.exists(os.path.join(store.root, "blobs", f"sha256-{sha}"))
        assert stats["store_bytes"] < stats["dense_bytes"] * 0.5
        # One blob each for the shared program, the shared metadata file
        # and the base's dense weights, plus one delta envelope a sibling.
        assert stats["n_blobs"] == 3 + 4

    def test_materialize_reconstructs_the_export_dir(self, store, tmp_path):
        base = _params(0)
        sib = _perturb(base, seed=2)
        _publish(store, tmp_path, "base", base)
        _publish(store, tmp_path, "sib", sib, base_policy="base")
        dest = str(tmp_path / "rebuilt")
        store.materialize("sib", dest)
        with open(os.path.join(dest, "program", "predict_fn.pt2"), "rb") as f:
            assert f.read() == _PROGRAM
        with open(os.path.join(dest, "variables.pt"), "rb") as f:
            assert f.read() == store.load_weights("sib")
        with pytest.raises(ArtifactStoreError):
            store.materialize("sib", dest)  # refuses to clobber

    def test_parity_gate_demotes_hot_leaf_to_dense_exact(self, store, tmp_path):
        """A leaf whose diff cannot reconstruct within tolerance ships
        dense-exact, per leaf, while its siblings still ship delta."""
        base = _params(0)
        sib = _perturb(base, seed=3)
        rng = np.random.RandomState(9)
        sib["dense0.bias"] = base["dense0.bias"] + torch.from_numpy(
            rng.standard_normal((16,)).astype(np.float32) * 50.0)
        _publish(store, tmp_path, "base", base)
        manifest = _publish(store, tmp_path, "sib", sib, base_policy="base",
                            regime="int8", tolerance=1e-3)
        leaves = manifest["payload"]["leaves"]
        assert leaves["dense"] >= 2  # the demoted leaf + the int64 step
        assert leaves["delta"] >= 1  # small-delta leaves still encode
        restored = _state(store.load_weights("sib"))
        assert torch.equal(restored["dense0.bias"], sib["dense0.bias"])

    def test_tolerance_zero_demotes_everything_and_round_trips_exact(self, store, tmp_path):
        base = _params(0)
        sib = _perturb(base, seed=4)
        _publish(store, tmp_path, "base", base)
        manifest = _publish(store, tmp_path, "sib", sib, base_policy="base", tolerance=0.0)
        assert manifest["payload"]["leaves"]["delta"] == 0
        restored = _state(store.load_weights("sib"))
        for name, value in sib.items():
            assert torch.equal(restored[name], value), name


class TestTypedRefusals:
    def test_every_corrupt_frame_variant_is_typed_never_partial(self, store, tmp_path):
        """analysis/corpus.py's frame family over the delta envelope: each
        truncation, seeded bitflip, forged length and bad magic raises
        ArtifactCorrupt from the public load path (the blob-level sha is
        re-addressed so the ENVELOPE checks are what fire)."""
        base = _params(0)
        _publish(store, tmp_path, "base", base)
        manifest = _publish(store, tmp_path, "sib", _perturb(base, seed=5),
                            base_policy="base")
        with open(os.path.join(store.root, "blobs",
                               f"sha256-{manifest['payload']['blob']}"), "rb") as f:
            envelope = f.read()
        variants = corpus.corrupt_frame_variants(envelope)
        assert len(variants) >= 15
        for name, bad in variants.items():
            _swap_payload_blob(store, "sib", bad)
            with pytest.raises(ArtifactCorrupt):
                store.load_weights("sib")
            with pytest.raises(ArtifactCorrupt):
                store.materialize("sib", str(tmp_path / f"dest-{name}"))

    def test_blob_bytes_corrupt_on_disk_refused(self, store, tmp_path):
        _publish(store, tmp_path, "base", _params(0))
        sha = store.manifest("base")["payload"]["blob"]
        path = os.path.join(store.root, "blobs", f"sha256-{sha}")
        with open(path, "rb") as f:
            data = bytearray(f.read())
        data[len(data) // 2] ^= 0x40
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ArtifactCorrupt):
            store.load_weights("base")
        os.unlink(path)
        with pytest.raises(ArtifactCorrupt):
            store.load_weights("base")  # a missing blob is corrupt, typed

    def test_base_missing_is_typed(self, store, tmp_path):
        base = _params(0)
        _publish(store, tmp_path, "base", base)
        _publish(store, tmp_path, "sib", _perturb(base, seed=6), base_policy="base")
        store.delete("base")
        with pytest.raises(BaseArtifactMissing):
            store.load_weights("sib")

    def test_cross_program_delta_refused_at_put(self, store, tmp_path):
        _publish(store, tmp_path, "base", _params(0))
        other_dir = str(tmp_path / "export-other-program")
        _write_export(other_dir, _perturb(_params(0), seed=7),
                      program=b"a different program entirely " * 256)
        with pytest.raises(ArtifactKeyMismatch):
            store.put(other_dir, "cross", base_policy="base")
        assert not store.has("cross")  # gate-fails-write-nothing

    def test_republished_base_weights_refused_at_read(self, store, tmp_path):
        """The delta is keyed to the base WEIGHTS it was encoded against."""
        base = _params(0)
        _publish(store, tmp_path, "base", base)
        _publish(store, tmp_path, "sib", _perturb(base, seed=8), base_policy="base")
        store.delete("base")
        _publish(store, tmp_path, "base", _params(99))  # same program
        with pytest.raises(ArtifactKeyMismatch):
            store.load_weights("sib")

    def test_transplanted_envelope_refused_by_fingerprint(self, store, tmp_path):
        """An intact delta payload moved under a policy of a DIFFERENT
        program family fails the key check, not the integrity check."""
        base_a = _params(0)
        _publish(store, tmp_path, "base", base_a)
        man_a = _publish(store, tmp_path, "sibA", _perturb(base_a, seed=11),
                         base_policy="base")
        other = ArtifactStore(str(tmp_path / "storeB"))
        dir_b = str(tmp_path / "export-baseB")
        _write_export(dir_b, base_a, program=b"program B " * 1024)
        other.put(dir_b, "base")
        dir_sb = str(tmp_path / "export-sibB")
        _write_export(dir_sb, _perturb(base_a, seed=12), program=b"program B " * 1024)
        other.put(dir_sb, "sibB", base_policy="base")
        with open(os.path.join(store.root, "blobs",
                               f"sha256-{man_a['payload']['blob']}"), "rb") as f:
            envelope_a = f.read()
        _swap_payload_blob(other, "sibB", envelope_a)
        with pytest.raises(ArtifactKeyMismatch):
            other.load_weights("sibB")

    def test_publish_and_lookup_refusals(self, store, tmp_path):
        _publish(store, tmp_path, "base", _params(0))
        with pytest.raises(PolicyExists):
            _publish(store, tmp_path, "base", _params(1))
        with pytest.raises(PolicyNotFound):
            store.load_weights("nope")
        with pytest.raises(PolicyNotFound):
            store.delete("nope")
        with pytest.raises(BaseArtifactMissing):
            _publish(store, tmp_path, "orphan", _params(2), base_policy="never-published")
        with pytest.raises(ValueError):
            store.put(str(tmp_path), "bad/id")
        not_export = str(tmp_path / "not-an-export")
        os.makedirs(not_export)
        with pytest.raises(ArtifactStoreError):
            store.put(not_export, "empty")


class TestFingerprint:
    def test_program_identity_ignores_weights(self):
        files_a = {"program/predict_fn.pt2": b"prog", "variables.pt": b"weights-1"}
        files_b = {"program/predict_fn.pt2": b"prog", "variables.pt": b"weights-2"}
        assert program_fingerprint(files_a) == program_fingerprint(files_b)
        files_c = {"program/predict_fn.pt2": b"other prog", "variables.pt": b"weights-1"}
        assert program_fingerprint(files_a) != program_fingerprint(files_c)

    def test_programless_export_falls_back_to_non_weight_files(self):
        files = {"t2r_metadata.json": b"{}", "variables.pt": b"w"}
        other = {"t2r_metadata.json": b"{}", "variables.pt": b"x"}
        assert program_fingerprint(files) == program_fingerprint(other)
        changed = {"t2r_metadata.json": b"{!}", "variables.pt": b"w"}
        assert program_fingerprint(files) != program_fingerprint(changed)

    def test_equals_the_jax_hex_on_the_same_file_bytes(self):
        # No program of JAX's: both fall back to the same files.
        files = {"t2r_metadata.json": b"{}", "assets.extra/t2r_assets.pbtxt": b"spec",
                 "aot/exec_none_b1.bin": b"package", "quant/params_int8.pt": b"q"}
        assert program_fingerprint(files) == jax_store.program_fingerprint(files)
        # The port's program files are the files JAX's fallback keys
        # (its own weights file left out by each).
        ours = {"program/predict_fn.pt2": b"prog", "variables.pt": b"w"}
        theirs = {"program/predict_fn.pt2": b"prog", "variables.msgpack": b"w"}
        assert program_fingerprint(ours) == jax_store.program_fingerprint(theirs)


# -- against the JAX store --------------------------------------------------------


def _mock_states():
    network = mocks.MockT2RModel(device_type="cpu").create_network()
    base = {k: v.detach().clone() for k, v in network.state_dict().items()}
    rng = np.random.RandomState(3)
    sib = {}
    for index, (name, value) in enumerate(base.items()):
        step = 50.0 if index == 1 else 1e-3  # one hot leaf for the gate
        sib[name] = value + torch.from_numpy(
            rng.standard_normal(tuple(value.shape)).astype(np.float32)) * step
    return network, base, sib


def _port_export(dirname, network, state):
    table = saved_model._flax_table(types.SimpleNamespace(network=network), state)
    _write_export(dirname, state, metadata={"flax_variables": table})


def _jax_export(dirname, network, state):
    os.makedirs(os.path.join(dirname, "stablehlo"), exist_ok=True)
    with open(os.path.join(dirname, "stablehlo", "predict_fn.bin"), "wb") as f:
        f.write(_PROGRAM)
    with open(os.path.join(dirname, "t2r_metadata.json"), "w") as f:
        json.dump({}, f)
    with open(os.path.join(dirname, "variables.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(sq.flax_variables(state, network)))


def _envelope_leaves(store, policy_id, load):
    sha = store.manifest(policy_id)["payload"]["blob"]
    with open(os.path.join(store.root, "blobs", f"sha256-{sha}"), "rb") as f:
        header, payload = _unpack(f.read())
    return header, load(payload)


def _bytes(value):
    if isinstance(value, torch.Tensor):
        value = value.contiguous()
        return value.view(torch.uint8).numpy().tobytes() if value.dtype.itemsize == 1 \
            else value.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(value)).tobytes()


@pytest.mark.parametrize("regime", ["int8", "fp16", "fp8_e4m3", "fp8_e5m2"])
def test_delta_payload_equals_jax_byte_for_byte(tmp_path, regime):
    network, base, sib = _mock_states()
    ours, theirs = ArtifactStore(str(tmp_path / "ours")), jax_store.ArtifactStore(
        str(tmp_path / "theirs"))
    kwargs = dict(regime=regime, block=64, tolerance=1e-3)
    for store, export in ((ours, _port_export), (theirs, _jax_export)):
        for policy_id, state, base_policy in (("base", base, None), ("sib", sib, "base")):
            dirname = str(tmp_path / f"{type(store).__module__}-{policy_id}")
            export(dirname, network, state)
            store.put(dirname, policy_id, base_policy=base_policy, **kwargs)
    our_header, our_leaves = _envelope_leaves(
        ours, "sib", lambda b: torch.load(io.BytesIO(b), weights_only=True))
    their_header, their_leaves = _envelope_leaves(theirs, "sib", pickle.loads)
    assert sorted(our_leaves) == sorted(their_leaves)
    encs = {path: meta["enc"] for path, meta in our_header["leaves"].items()}
    assert encs == {path: meta["enc"] for path, meta in their_header["leaves"].items()}
    # The hot leaf's int8 or fp8 diff misses the 1e-3 gate (fp16's holds),
    # in both packages alike.
    assert ("dense" in encs.values()) == (regime != "fp16"), encs
    for path, mine in our_leaves.items():
        theirs_leaf = their_leaves[path]
        assert our_header["leaves"][path]["shape"] == their_header["leaves"][path]["shape"]
        if encs[path] == "dense":
            assert _bytes(mine) == _bytes(theirs_leaf), path
            continue
        assert set(mine) == set(theirs_leaf) == {"q", "s"}
        for key in ("q", "s"):
            assert _bytes(mine[key]) == _bytes(theirs_leaf[key]), (path, key)
    # The reconstructed weights, in the torch layout, are JAX's tree.
    restored = _state(ours.load_weights("sib"))
    want = serialization.msgpack_restore(theirs.load_weights("sib"))
    got = sq.flax_variables(restored, network)
    for path, leaf in jax_store._flatten_tree(want):
        node = got
        for part in path.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=path)


def _age_blobs(store, seconds=7200.0):
    """Back-date every blob so the gc grace window does not shield it."""
    blob_dir = os.path.join(store.root, "blobs")
    past = time.time() - seconds
    for name in os.listdir(blob_dir):
        os.utime(os.path.join(blob_dir, name), (past, past))


def _blob_names(store):
    blob_dir = os.path.join(store.root, "blobs")
    return {n for n in os.listdir(blob_dir) if n.startswith("sha256-")}


class TestGC:
    def test_all_live_deletes_nothing(self, store, tmp_path):
        params = _params(0)
        _publish(store, tmp_path, "base", params)
        _publish(store, tmp_path, "sib", _perturb(params, 1), base_policy="base")
        _age_blobs(store)
        before = _blob_names(store)
        stats = store.gc()
        assert stats["deleted"] == 0
        assert stats["bytes_freed"] == 0
        assert stats["live"] == stats["scanned"] == len(before)
        assert _blob_names(store) == before

    def test_republish_then_rooted_sweep_reclaims_old_generation(self, store, tmp_path):
        params = _params(0)
        _publish(store, tmp_path, "base-v1", params)
        _publish(store, tmp_path, "sib", _perturb(params, 1), base_policy="base-v1")
        _publish(store, tmp_path, "base-v2", _perturb(params, 2, scale=5e-3))
        _age_blobs(store)
        stats = store.gc(roots=["base-v2"])
        assert stats["deleted"] > 0
        store.load_weights("base-v2")
        with pytest.raises(ArtifactStoreError):
            store.load_weights("base-v1")

    def test_delta_base_chain_is_reachable(self, store, tmp_path):
        params = _params(0)
        _publish(store, tmp_path, "base", params)
        sib = _perturb(params, 1)
        _publish(store, tmp_path, "sib", sib, base_policy="base")
        _publish(store, tmp_path, "grand", _perturb(sib, 2), base_policy="sib")
        _age_blobs(store)
        stats = store.gc(roots=["grand"])
        assert stats["deleted"] == 0
        assert store.load_weights("grand") == store.load_weights("grand")

    def test_dry_run_counts_without_deleting(self, store, tmp_path):
        params = _params(0)
        _publish(store, tmp_path, "base-v1", params)
        _publish(store, tmp_path, "base-v2", _perturb(params, 2, scale=5e-3))
        _age_blobs(store)
        before = _blob_names(store)
        dry = store.gc(roots=["base-v2"], dry_run=True)
        assert dry["dry_run"] is True
        assert dry["deleted"] > 0
        assert dry["bytes_freed"] > 0
        assert _blob_names(store) == before
        real = store.gc(roots=["base-v2"])
        assert real["deleted"] == dry["deleted"]
        assert real["bytes_freed"] == dry["bytes_freed"]
        assert len(_blob_names(store)) == len(before) - real["deleted"]

    def test_grace_window_shields_inflight_put(self, store, tmp_path):
        _publish(store, tmp_path, "base", _params(0))
        _age_blobs(store)
        orphan = os.path.join(store.root, "blobs", "sha256-" + "ab" * 32)
        with open(orphan, "wb") as f:
            f.write(b"manifest has not landed yet")
        stats = store.gc()
        assert os.path.exists(orphan)
        assert stats["kept_young"] == 1
        assert stats["deleted"] == 0
        stats = store.gc(grace_s=0.0)
        assert not os.path.exists(orphan)
        assert stats["deleted"] == 1

    def test_tmp_files_are_never_candidates(self, store, tmp_path):
        _publish(store, tmp_path, "base", _params(0))
        tmp_blob = os.path.join(store.root, "blobs", ".tmp-partial-write")
        with open(tmp_blob, "wb") as f:
            f.write(b"half a blob")
        _age_blobs(store)
        stats = store.gc(grace_s=0.0)
        assert os.path.exists(tmp_blob)
        assert stats["deleted"] == 0

    def test_corrupt_root_manifest_is_typed_refusal(self, store, tmp_path):
        params = _params(0)
        _publish(store, tmp_path, "base-v1", params)
        _publish(store, tmp_path, "base-v2", _perturb(params, 2, scale=5e-3))
        _age_blobs(store)
        with open(os.path.join(store.root, "policies", "base-v2.json"), "w") as f:
            f.write("{ torn manifest")
        before = _blob_names(store)
        with pytest.raises(ArtifactCorrupt, match="repair or delete"):
            store.gc(grace_s=0.0)
        assert _blob_names(store) == before

    def test_missing_explicit_root_is_typed(self, store, tmp_path):
        _publish(store, tmp_path, "base", _params(0))
        with pytest.raises(PolicyNotFound):
            store.gc(roots=["absent"])

    def test_late_landing_manifest_is_remarked(self, store, tmp_path, monkeypatch):
        params = _params(0)
        _publish(store, tmp_path, "base-v1", params)
        _publish(store, tmp_path, "base-v2", _perturb(params, 2, scale=5e-3))
        _age_blobs(store)
        v1_manifest = store.manifest("base-v1")
        real_policies = type(store).policies
        calls = {"n": 0}

        def racing_policies(self):
            ids = real_policies(self)
            calls["n"] += 1
            if calls["n"] == 2:  # the sweep-side re-listing
                with open(os.path.join(self.root, "policies", "late-lander.json"), "w") as f:
                    json.dump(v1_manifest, f)
                ids = real_policies(self)
            return ids

        monkeypatch.setattr(type(store), "policies", racing_policies)
        stats = store.gc(roots=["base-v2"], grace_s=0.0)
        monkeypatch.undo()
        assert stats["deleted"] == 0
        store.load_weights("base-v2")
        store.load_weights("late-lander")


# -- the multi-policy loader ---------------------------------------------------------


def test_exported_policy_loader_boots_store_policies(tmp_path):
    """Two mock exports of other weights (each program holds its weights,
    so they are no siblings: dense policies), each materialized and served
    by its own prewarmed PolicyServer."""
    trainer = Trainer(mocks.MockT2RModel(device_type="cpu"), device="cpu")
    exports = {}
    for policy_id, seed in (("pi0", 0), ("pi1", 1)):
        state = trainer.init_state(torch.Generator().manual_seed(seed))
        exporter = LatestExporter(name="latest", warmup_batch_sizes=(1, 2))
        exporter.maybe_export(step=seed + 1, state=state, eval_metrics={},
                              compiled=trainer, model_dir=str(tmp_path / policy_id))
        exports[policy_id] = latest_export_dir(exporter.export_root(str(tmp_path / policy_id)))
    store = ArtifactStore(str(tmp_path / "store"))
    store.put(exports["pi0"], "pi0")
    with pytest.raises(ArtifactKeyMismatch):
        store.put(exports["pi1"], "pi1", base_policy="pi0")
    store.put(exports["pi1"], "pi1")
    loader, catalog = exported_policy_loader(store.root, work_dir=str(tmp_path / "work"),
                                             max_wait_ms=1, device="cpu")
    assert catalog == ["pi0", "pi1"]
    request = {"x": np.array([0.5, -0.25, 1.0], np.float32)}
    replies = {}
    for policy_id in catalog:
        server = loader(policy_id)
        try:
            replies[policy_id] = server.call(request, timeout=30).outputs["a_predicted"]
            snap = server.snapshot()
        finally:
            server.stop()
        assert server.mem_bytes == store.manifest(policy_id)["payload"]["weights_nbytes"]
        assert snap["buckets"] == [1, 2] and list(snap["prewarmed"].values()) == [[1, 2]]
        want = ExportedModel(exports[policy_id], device="cpu").predict(
            {k: v[None] for k, v in request.items()})["a_predicted"][0]
        np.testing.assert_array_equal(replies[policy_id], want)
    assert not np.array_equal(replies["pi0"], replies["pi1"])
