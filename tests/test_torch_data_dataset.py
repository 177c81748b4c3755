"""The port's RecordDataset and record input generators against the JAX
package's: the same seed gives the same batches byte for byte.

Shards of small JPEG records (written by the JAX package's encoder) go
through both packages' RecordDataset in train mode (file shuffle,
interleave, shuffle buffer, repeat): the thread backend with decode-time
ROI on and off, the process backend, and the process backend with image
decoding left to the parent (the path the card's nvJPEG codec takes);
then the record input generators (Default, Fractional, MultiEval,
Weighted, create_multi_eval_generators) with the critic's decode ROIs,
skip mode on a corrupt record, the shared-memory ring's size check, and
the pinned ring's reuse rule.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import dataset as jax_dataset
from tensor2robot_tpu.data import encoder as jax_encoder
from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.data import roi as jax_roi
from tensor2robot_tpu.data import tfrecord as jax_tfrecord
from tensor2robot_tpu.data import wire as jax_wire
from tensor2robot_tpu.specs import ExtendedTensorSpec as JaxSpec
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu.specs import make_random_numpy as jax_random_numpy
from tensor2robot_tpu_torch.data import codec, dataset, input_generators, roi, wire
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct
from tensor2robot_tpu_torch.train import infeed

LAYOUT = {
    "features/image": dict(shape=(40, 56, 3), dtype=np.uint8, name="image",
                           data_format="jpeg"),
    "features/pose": dict(shape=(3,), dtype=np.float32, name="pose"),
    "features/tags": dict(shape=(4,), dtype=np.int64, name="tags",
                          varlen_default_value=0),
    "labels/reward": dict(shape=(1,), dtype=np.float32, name="reward"),
}
SHARDS, PER_SHARD, BATCH = 3, 6, 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _fresh_caches():
    wire.reset_decode_cache()
    jax_wire.reset_decode_cache()


def _specs():
    jax_spec, port_spec = JaxStruct(), TensorSpecStruct()
    for key, kwargs in LAYOUT.items():
        jax_spec[key] = JaxSpec(**kwargs)
        port_spec[key] = ExtendedTensorSpec(**kwargs)
    return jax_spec, port_spec


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    directory = tmp_path_factory.mktemp("shards")
    jax_spec, _ = _specs()
    for shard in range(SHARDS):
        values = jax_random_numpy(jax_spec, batch_size=PER_SHARD, seed=shard)
        records = [
            jax_encoder.encode_example(
                jax_spec, {k: np.asarray(v[i]) for k, v in values.items()})
            for i in range(PER_SHARD)
        ]
        jax_tfrecord.write_tfrecords(str(directory / f"d-{shard}.tfrecord"), records)
    return str(directory / "d-*.tfrecord")


def _same_batches(want, got, n):
    for _ in range(n):
        a, b = next(want), next(got)
        assert set(a.keys()) == set(b.keys())
        for key in a.keys():
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.dtype == y.dtype and x.shape == y.shape, key
            np.testing.assert_array_equal(x, y, err_msg=key)


def _roi(module, mode="random"):
    return {"features/image": module.DecodeROI(24, 32, mode)}


@pytest.mark.parametrize("decode_roi", [False, True], ids=["full", "roi"])
def test_thread_backend_matches_jax(shards, decode_roi):
    jax_spec, port_spec = _specs()
    common = dict(batch_size=BATCH, mode="train", seed=5, shuffle_buffer_size=5,
                  num_parse_workers=2, prefetch_depth=1)
    want = jax_dataset.RecordDataset(
        jax_spec, shards, decode_roi=_roi(jax_roi) if decode_roi else None, **common)
    got = dataset.RecordDataset(
        port_spec, shards, decode_roi=_roi(roi) if decode_roi else None, **common)
    # Three epochs' worth: the file order reshuffles each epoch.
    _same_batches(iter(want), iter(got), 3 * SHARDS * PER_SHARD // BATCH)


@pytest.mark.parametrize("defer", [False, True], ids=["decode", "parent-decodes"])
def test_process_backend_matches_jax(shards, monkeypatch, defer):
    """Two spawned workers; with `defer` the workers return the encoded
    images and the parent decodes them, as with the card's codec."""
    monkeypatch.setattr(codec, "needs_card", lambda: defer)
    jax_spec, port_spec = _specs()
    common = dict(batch_size=BATCH, mode="eval", seed=1, num_parse_workers=2,
                  prefetch_depth=1, parse_backend="process")
    want = jax_dataset.RecordDataset(jax_spec, shards, decode_roi=_roi(jax_roi, "center"),
                                     **common)
    got = dataset.RecordDataset(port_spec, shards, decode_roi=_roi(roi, "center"), **common)
    try:
        batches = list(got)
        assert len(batches) == SHARDS * PER_SHARD // BATCH
        _same_batches(iter(want), iter(batches), len(batches))
        assert got.stats()["fast_fallbacks"] == 0
    finally:
        want.close()
        got.close()


def test_golden_record_generators_with_the_critics_rois():
    """The critic's preprocessor publishes its crop: train batches come
    random-cropped at decode time, eval batches center-cropped, as the JAX
    package's."""
    from tools import make_qtopt_golden as golden

    from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
        Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom as Critic,
    )

    jax_model = golden.build_model()
    model = Critic(image_size=golden.IMAGE_SIZE, num_convs=golden.NUM_CONVS)
    for mode in ("train", "eval"):
        kwargs = dict(file_patterns=golden.RECORD_PATH, batch_size=4, seed=3,
                      shuffle_buffer_size=4, num_parse_workers=1, prefetch_depth=0)
        want = jax_generators.DefaultRecordInputGenerator(**kwargs)
        got = input_generators.DefaultRecordInputGenerator(**kwargs)
        want.set_specification_from_model(jax_model, mode)
        got.set_specification_from_model(model, mode)
        assert got.decode_rois(mode)["features/state/image"].mode == (
            "random" if mode == "train" else "center")
        batches = iter(got.create_dataset(mode))
        _same_batches(iter(want.create_dataset(mode)), batches, 1)
        # The preprocessor takes the cropped images without cropping again.
        batch = next(batches)
        assert batch["features/state/image"].shape == (4, 96, 96, 3)
        features, _ = model.preprocessor.preprocess(
            {k: torch.from_numpy(np.asarray(v)) for k, v in batch["features"].items()},
            mode=mode)
        assert features["state/image"].shape == (4, 96, 96, 3)
        np.testing.assert_array_equal(
            features["state/image"].numpy(),
            np.asarray(batch["features/state/image"], np.float32) / 255)


def test_fractional_multi_eval_and_weighted_generators(shards, monkeypatch):
    jax_spec, port_spec = _specs()
    files = sorted(jax_tfrecord.list_files(shards))
    evals = {"first": files[0], "rest": ",".join(files[1:])}
    pairs = [
        (jax_generators.FractionalRecordInputGenerator(
            file_fraction=0.4, file_patterns=shards, batch_size=2, seed=2),
         input_generators.FractionalRecordInputGenerator(
            file_fraction=0.4, file_patterns=shards, batch_size=2, seed=2)),
        (jax_generators.WeightedRecordInputGenerator(
            [files[0], files[1:]], weights=[1, 3], batch_size=2, seed=4,
            num_parse_workers=0),
         input_generators.WeightedRecordInputGenerator(
            [files[0], files[1:]], weights=[1, 3], batch_size=2, seed=4,
            num_parse_workers=0)),
    ]
    monkeypatch.setenv("T2R_MULTI_EVAL_NAME", "rest")
    pairs.append((jax_generators.MultiEvalRecordInputGenerator(evals, batch_size=2),
                  input_generators.MultiEvalRecordInputGenerator(evals, batch_size=2)))
    many = (jax_generators.create_multi_eval_generators(evals, batch_size=2),
            input_generators.create_multi_eval_generators(evals, batch_size=2))
    assert list(many[0]) == list(many[1]) == ["first", "rest"]
    pairs += [(many[0][name], many[1][name]) for name in evals]
    for want, got in pairs:
        want.set_specification(*_split(jax_spec))
        got.set_specification(*_split(port_spec))
        mode = "eval" if "MultiEval" in type(got).__name__ else "train"
        _same_batches(iter(want.create_dataset(mode)), iter(got.create_dataset(mode)), 3)
    with pytest.raises(ValueError, match="not in"):
        input_generators.MultiEvalRecordInputGenerator(evals, eval_name="nope")


def _split(spec):
    features, labels = type(spec)(), type(spec)()
    for key, value in spec.items():
        group, rest = key.split("/", 1)
        (features if group == "features" else labels)[rest] = value
    return features, labels


def test_skip_mode_drops_and_counts_like_jax(shards, tmp_path, monkeypatch):
    monkeypatch.setenv("T2R_PARSE_ON_ERROR", "skip")
    jax_spec, port_spec = _specs()
    records = list(jax_tfrecord.read_tfrecords(jax_tfrecord.list_files(shards)[0]))
    records[2] = records[2][: len(records[2]) // 2]  # a torn record
    path = str(tmp_path / "torn.tfrecord")
    jax_tfrecord.write_tfrecords(path, records)
    common = dict(batch_size=BATCH, mode="eval", num_parse_workers=0, prefetch_depth=0,
                  drop_remainder=False)
    want = jax_dataset.RecordDataset(jax_spec, path, **common)
    got = dataset.RecordDataset(port_spec, path, **common)
    a, b = list(want), list(got)
    assert [len(x["labels/reward"]) for x in b] == [3, 2]
    _same_batches(iter(a), iter(b), len(a))
    assert got.stats() == want.stats()
    assert got.stats()["records_skipped"] == 1


def test_shard_by_host_without_a_process_group_reads_every_file(shards):
    _, port_spec = _specs()
    got = dataset.RecordDataset(port_spec, shards, batch_size=BATCH, shard_by_host=True)
    assert len(got._files[""]) == SHARDS


def test_shm_ring_names_the_size_it_needs(monkeypatch):
    monkeypatch.setattr(dataset, "_shm_free_bytes", lambda: 1000)
    with pytest.raises(RuntimeError, match=r"needs 8192 bytes .* has 1000 bytes free"):
        dataset._ShmBatchRing(None, 4096, 2)


def test_pinned_ring_reuses_a_buffer_once_it_is_free(monkeypatch):
    """Pinning needs a card: here the ring's buffers are plain memory, and
    a completed or pending copy is a stand-in event."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda n, dtype, pin_memory: empty(n, dtype=dtype))

    class Event:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

    ring = infeed.PinnedRing()
    first = ring.alloc((2, 3))
    address = first.data_ptr()
    second = ring.alloc((2, 3))  # the first is still held
    assert second.data_ptr() != address and len(ring) == 2
    first._t2r_slot.copied = Event(done=False)
    del first
    third = ring.alloc((6,))  # the first's copy is still in flight
    assert third.data_ptr() not in (address, second.data_ptr()) and len(ring) == 3
    ring._slots[0].copied = Event(done=True)
    assert ring.alloc((1, 6)).data_ptr() == address and len(ring) == 3
