"""The port's parsers and encoder against the JAX package's.

`FastSpecParser` (data/wire.py) and the `SpecParser` oracle
(data/parser.py, the port's own Example wire decoder in place of
protobuf) against the JAX package's two, exactly: same keys, dtypes,
shapes and bits, on the golden QT-Opt record and on generated context,
sequence, multi-dataset, varlen, optional, bfloat16 and image-stack
specs, with and without decode-time ROI. Records written by either
package's encoder are read by the other's parsers.

The rejection side, on the JAX package's malformed-record corpus
(analysis/corpus.py) and derandomized hypothesis insertions: the port's
FastSpecParser refuses exactly the records the JAX package's refuses and
parses the others to the same bits, and the dataset seam (fast parse with
oracle fallback) behaves as the JAX package's: the same batch or a
refusal of both.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tensor2robot_tpu.analysis import corpus
from tensor2robot_tpu.data import dataset as jax_dataset
from tensor2robot_tpu.data import encoder as jax_encoder
from tensor2robot_tpu.data import parser as jax_parser
from tensor2robot_tpu.data import roi as jax_roi
from tensor2robot_tpu.data import tfrecord as jax_tfrecord
from tensor2robot_tpu.data import wire as jax_wire
from tensor2robot_tpu.specs import ExtendedTensorSpec as JaxSpec
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu.specs import make_random_numpy as jax_random_numpy
from tensor2robot_tpu_torch.data import dataset, encoder, parser, roi, wire
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct

GOLDEN = "tests/golden/qtopt_train.tfrecord"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _no_decode_cache(monkeypatch):
    """Every parse decodes (the caches are process-wide)."""
    monkeypatch.setenv("T2R_DECODE_CACHE_MB", "0")
    wire.reset_decode_cache()
    jax_wire.reset_decode_cache()


def both(layout):
    """The same spec structure in both packages: {key: spec kwargs}."""
    jax_spec, port_spec = JaxStruct(), TensorSpecStruct()
    for key, kwargs in layout.items():
        jax_spec[key] = JaxSpec(**kwargs)
        port_spec[key] = ExtendedTensorSpec(**kwargs)
    return jax_spec, port_spec


def _numpy(value):
    if isinstance(value, torch.Tensor):
        return value.float().numpy() if value.dtype == torch.bfloat16 else value.numpy()
    value = np.asarray(value)
    return value.astype(np.float32) if value.dtype.name == "bfloat16" else value


def assert_same(want, got, what=""):
    assert set(want.keys()) == set(got.keys()), what
    for key in want.keys():
        w, g = _numpy(want[key]), _numpy(got[key])
        assert w.dtype == g.dtype and w.shape == g.shape, (what, key, w.dtype, g.dtype)
        np.testing.assert_array_equal(w, g, err_msg=f"{what} {key}")


def parse_all(jax_spec, port_spec, batch, jax_roi_map=None, port_roi_map=None):
    """Parses one batch with the four parsers; all four must agree."""
    want = jax_parser.SpecParser(jax_spec).parse_batch(batch, roi=jax_roi_map)
    assert_same(want, jax_wire.FastSpecParser(jax_spec).parse_batch(batch, roi=jax_roi_map),
                "jax fast")
    assert_same(want, parser.SpecParser(port_spec).parse_batch(batch, roi=port_roi_map),
                "port oracle")
    fast = wire.FastSpecParser(port_spec)
    assert fast.supported, fast.unsupported_reason
    assert_same(want, fast.parse_batch(batch, roi=port_roi_map), "port fast")
    return want


def _rows(values, n):
    return [{k: np.asarray(v[i]) for k, v in values.items()} for i in range(n)]


FAMILIES = {
    "numerics": {
        "a/pose": dict(shape=(7,), dtype=np.float32, name="pose"),
        "a/count": dict(shape=(2, 3), dtype=np.int64, name="count"),
        "a/flag": dict(shape=(1,), dtype=np.bool_, name="flag"),
        "a/small": dict(shape=(4,), dtype=np.int32, name="small"),
        "b/wide": dict(shape=(3,), dtype=np.float64, name="wide"),
        "b/half": dict(shape=(2,), dtype="bfloat16", name="half"),
        "b/scalar": dict(shape=(), dtype=np.float32, name="scalar"),
    },
    "varlen": {
        "tags": dict(shape=(5,), dtype=np.int64, name="tags", varlen_default_value=-3),
        "xs": dict(shape=(4,), dtype=np.float32, name="xs", varlen_default_value=0.5),
    },
    "images": {
        "rgb": dict(shape=(24, 32, 3), dtype=np.uint8, name="rgb", data_format="jpeg"),
        "grey": dict(shape=(24, 32, 1), dtype=np.uint8, name="grey", data_format="jpeg"),
        "fimg": dict(shape=(16, 16, 3), dtype=np.float32, name="fimg", data_format="jpeg"),
        "stack": dict(shape=(2, 16, 24, 3), dtype=np.uint8, name="stack",
                      data_format="jpeg"),
    },
    "sequence": {
        "ctx": dict(shape=(2,), dtype=np.float32, name="ctx"),
        "obs": dict(shape=(3,), dtype=np.float32, name="obs", is_sequence=True),
        "act": dict(shape=(1,), dtype=np.int64, name="act", is_sequence=True),
        "cam": dict(shape=(16, 16, 3), dtype=np.uint8, name="cam", is_sequence=True,
                    data_format="jpeg"),
    },
}


class TestParity:
    def test_golden_record(self):
        from tools import make_qtopt_golden as golden

        model = golden.build_model()
        jax_spec = JaxStruct()
        for key, value in model.preprocessor.get_in_feature_specification("train").items():
            jax_spec[f"features/{key}"] = value
        for key, value in model.preprocessor.get_in_label_specification("train").items():
            jax_spec[f"labels/{key}"] = value
        port_spec = TensorSpecStruct()
        for key, spec in jax_spec.items():
            port_spec[key] = ExtendedTensorSpec(
                shape=spec.shape, dtype=np.dtype(spec.dtype), name=spec.name,
                data_format=spec.data_format)
        records = list(jax_tfrecord.read_tfrecords(GOLDEN))
        parse_all(jax_spec, port_spec, records)
        for mode in ("random", "center", "fixed"):
            request = dict(height=96, width=96, mode=mode,
                           **({"y": 3, "x": 101} if mode == "fixed" else {}))
            jax_map = jax_roi.resolve_decode_rois(
                {"features/state/image": jax_roi.DecodeROI(**request)}, jax_spec,
                len(records), np.random.default_rng(7))
            port_map = roi.resolve_decode_rois(
                {"features/state/image": roi.DecodeROI(**request)}, port_spec,
                len(records), np.random.default_rng(7))
            np.testing.assert_array_equal(jax_map["features/state/image"].ys,
                                          port_map["features/state/image"].ys)
            got = parse_all(jax_spec, port_spec, records, jax_map, port_map)
            assert got["features/state/image"].shape == (8, 96, 96, 3)

    @pytest.mark.parametrize("family", sorted(FAMILIES))
    def test_generated_records_both_encoders(self, family):
        jax_spec, port_spec = both(FAMILIES[family])
        values = jax_random_numpy(jax_spec, batch_size=3, sequence_length=2, seed=11)
        if family == "numerics":
            values["a/count"][0, 0, 0] = -(1 << 40)  # negative and 10-byte varints
            values["a/count"][1, 1, 2] = (1 << 62) + 5
        rows = _rows(values, 3)
        write_spec = (jax_spec, port_spec)
        if family == "varlen":
            rows[0]["tags"] = np.arange(7)  # clipped
            rows[1]["xs"] = np.ones(2, np.float32)  # padded
        elif family == "images":
            for row in rows:  # float image specs still store uint8 pixels
                row["fimg"] = (row["fimg"] * 255).astype(np.uint8)
            write_spec = both(dict(FAMILIES[family],
                                   fimg=dict(FAMILIES[family]["fimg"], dtype=np.uint8)))
        if family == "sequence":
            rows[2] = {k: (v[:1] if FAMILIES[family][k].get("is_sequence") else v)
                       for k, v in rows[2].items()}  # a shorter episode
        theirs = [jax_encoder.encode_example(write_spec[0], row) for row in rows]
        ours = [encoder.encode_example(write_spec[1], row) for row in rows]
        want = parse_all(jax_spec, port_spec, theirs)
        assert_same(want, parse_all(jax_spec, port_spec, ours), "port-written")

    def test_dataset_keys_and_optional_features(self):
        jax_spec, port_spec = both({
            "left/x": dict(shape=(2,), dtype=np.float32, name="x", dataset_key="left"),
            "right/y": dict(shape=(1,), dtype=np.int64, name="y", dataset_key="right"),
            "right/maybe": dict(shape=(1,), dtype=np.float32, name="maybe",
                                dataset_key="right", is_optional=True),
        })
        values = jax_random_numpy(jax_spec, batch_size=2, seed=3)
        rows = _rows(values, 2)
        for row in rows:
            del row["right/maybe"]
        for write in (jax_encoder.encode_examples_by_dataset,
                      encoder.encode_examples_by_dataset):
            per_key = [write(port_spec if write is encoder.encode_examples_by_dataset
                             else jax_spec, row) for row in rows]
            batch = {k: [r[k] for r in per_key] for k in ("left", "right")}
            got = parse_all(jax_spec, port_spec, batch)
            assert "right/maybe" not in got

    def test_partial_optional_and_missing_required_are_refused(self):
        jax_spec, port_spec = both({
            "x": dict(shape=(1,), dtype=np.float32, name="x"),
            "o": dict(shape=(1,), dtype=np.float32, name="o", is_optional=True),
        })
        full = encoder.encode_example(port_spec, {"x": np.ones(1), "o": np.ones(1)})
        bare = encoder.encode_example(port_spec, {"x": np.ones(1)})
        empty = b""
        for batch, error in (([full, bare], ValueError), ([empty], KeyError)):
            for make in (parser.SpecParser, wire.FastSpecParser,
                         jax_parser.SpecParser, jax_wire.FastSpecParser):
                spec = port_spec if make in (parser.SpecParser, wire.FastSpecParser) else jax_spec
                with pytest.raises(error):
                    make(spec).parse_batch(batch)


# -- the rejection side -----------------------------------------------------------


def _outcome(fn):
    """(result, None) or (None, the refusal): protobuf's DecodeError and
    PIL's errors count as refusals like the port's ValueErrors."""
    try:
        return fn(), None
    except Exception as err:  # noqa: BLE001 — any refusal is compared
        return None, err


@pytest.fixture(scope="module")
def fuzz_specs():
    jax_spec = corpus.fuzz_spec()
    port_spec = TensorSpecStruct()
    for key, spec in jax_spec.items():
        port_spec[key] = ExtendedTensorSpec(
            shape=spec.shape, dtype=np.dtype(spec.dtype), name=spec.name,
            data_format=spec.data_format,
            varlen_default_value=spec.varlen_default_value)
    return jax_spec, port_spec


def assert_refused_alike(specs, batch, what):
    """FastSpecParser against FastSpecParser, and the dataset seam (fast
    parse, oracle fallback) against the JAX package's seam."""
    jax_spec, port_spec = specs
    want, want_err = _outcome(lambda: jax_wire.FastSpecParser(jax_spec).parse_batch(batch))
    got, got_err = _outcome(lambda: wire.FastSpecParser(port_spec).parse_batch(batch))
    assert (want_err is None) == (got_err is None), (what, want_err, got_err)
    if want is not None:
        assert_same(want, got, what)
    want, want_err = _outcome(lambda: jax_dataset._parse_chunk_impl(
        jax_dataset._FastParseState(jax_spec, True), jax_parser.SpecParser(jax_spec),
        batch))
    got, got_err = _outcome(lambda: dataset._parse_chunk_impl(
        dataset._FastParseState(port_spec, True), parser.SpecParser(port_spec), batch))
    assert (want_err is None) == (got_err is None), (what, want_err, got_err)
    if want is not None:
        assert_same(want, got, what)
    return want_err is None


@pytest.fixture(scope="module")
def fuzz_records():
    return corpus.valid_example_records(n=3)


class TestMalformedRecords:
    def test_valid_records(self, fuzz_specs, fuzz_records):
        assert assert_refused_alike(fuzz_specs, fuzz_records, "valid")

    def test_protobuf_pathologies(self, fuzz_specs):
        cases = corpus.protobuf_pathologies()
        for name, framed in cases.items():
            assert_refused_alike(fuzz_specs, [framed[12:-4]], name)

    def test_truncations(self, fuzz_specs, fuzz_records):
        record = fuzz_records[0]
        cuts = list(range(0, 64)) + list(range(64, len(record), 97))
        accepted = sum(assert_refused_alike(fuzz_specs, [record[:cut]], f"cut {cut}")
                       for cut in cuts)
        assert accepted < len(cuts)

    def test_bitflips(self, fuzz_specs, fuzz_records):
        rng = np.random.RandomState(7)
        for i in range(48):
            record = bytearray(fuzz_records[1])
            offset = int(rng.randint(0, len(record)))
            record[offset] ^= 1 << int(rng.randint(0, 8))
            assert_refused_alike(fuzz_specs, [bytes(record)], f"flip {i} at {offset}")

    def test_one_bad_record_poisons_the_batch(self, fuzz_specs, fuzz_records):
        bad = fuzz_records[0][: len(fuzz_records[0]) // 2]
        assert not assert_refused_alike(
            fuzz_specs, [fuzz_records[1], bad, fuzz_records[2]], "mixed")

    def test_random_garbage(self, fuzz_specs):
        rng = np.random.RandomState(13)
        for size in (0, 1, 7, 64, 1024):
            blob = rng.randint(0, 256, size=size, dtype=np.uint8).tobytes()
            assert_refused_alike(fuzz_specs, [blob], f"garbage {size}")

    def test_wire_constructs_protobuf_accepts(self, fuzz_specs, fuzz_records):
        """Records the fast scanner refuses but protobuf parses (a group,
        mixed packed and unpacked floats): the seam's oracle must read them
        as protobuf does."""
        pose = parser.decode_example(fuzz_records[0], False)[0]["pose"]
        floats = np.concatenate(pose.values).astype("<f4")
        mixed = (b"\x12" + bytes([2 + 4 * 6 + 5]) + b"\x0a" + bytes([4 * 6])
                 + floats[:6].tobytes() + b"\x0d" + floats[6:].tobytes())
        entry = b"\x0a\x04pose\x12" + bytes([len(mixed)]) + mixed
        features = b"\x0a" + bytes([len(entry)]) + entry
        record = fuzz_records[0] + b"\x0a" + bytes([len(features)]) + features
        grouped = fuzz_records[1] + b"\x1b\x08\x01\x1c"
        for name, data in (("mixed packing", record), ("group", grouped),
                           ("field 0", fuzz_records[2] + b"\x00\x01")):
            assert_refused_alike(fuzz_specs, [data], name)

    def test_a_value_list_overrunning_its_frame(self, fuzz_specs, fuzz_records):
        """A float_list frame claiming 2 bytes whose packed run takes 30,
        ending exactly at its Feature's end: only the list's own frame
        check sees it, and protobuf refuses it."""
        run = np.arange(7, dtype="<f4").tobytes()
        feature = b"\x12\x02" + b"\x0a" + bytes([len(run)]) + run
        entry = b"\x0a\x04pose\x12" + bytes([len(feature)]) + feature
        features = b"\x0a" + bytes([len(entry)]) + entry
        record = fuzz_records[0] + b"\x0a" + bytes([len(features)]) + features
        assert not assert_refused_alike(fuzz_specs, [record], "overrun")
        with pytest.raises(wire.FastParseError, match="overran its frame"):
            wire.FastSpecParser(fuzz_specs[1]).parse_batch([record])

    @settings(max_examples=40, deadline=None, derandomize=True, database=None)
    @given(index=st.integers(0, 2), offset=st.integers(0, 4096),
           payload=st.binary(min_size=1, max_size=64))
    def test_insertion_mutations(self, fuzz_specs, fuzz_records, index, offset, payload):
        record = fuzz_records[index]
        offset %= len(record) + 1
        assert_refused_alike(fuzz_specs, [record[:offset] + payload + record[offset:]],
                             f"insert at {offset}")
