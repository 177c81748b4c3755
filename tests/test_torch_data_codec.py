"""The port's native TFRecord framing and JPEG codec against the JAX
package's.

The port builds its own copies of the native sources
(tensor2robot_tpu_torch/data/csrc) with g++ at first use; here, where
libjpeg is installed, the codec is libjpeg's. Held, all exactly:

  * CRC32-C: native against the port's plain Python version and the JAX
    package's; record framing, indexing and the streaming reader on the
    same bytes, and the same refusals on the malformed-record corpus;
  * decode, grayscale and ROI decode against the JAX package's
    decode_image (libjpeg or PIL), on 4:2:0, 4:4:4, greyscale and
    progressive sources; ROI equals the full decode's crop at window
    edges and sub-MCU offsets;
  * the encoder: PIL reads the port's JPEGs back as the port does, and
    the port's q95 JPEG of a frame is PIL's to the byte;
  * the malformed-JPEG corpus: the port refuses what the JAX package
    refuses, and where both decode they agree;
  * libjpeg's q95 round trip of chip_smoke.py's seeded 512x640 frames,
    the measurement chip_smoke's nvJPEG bound is built on.
"""

import importlib.util
import io
import pathlib
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from tensor2robot_tpu.analysis import corpus
from tensor2robot_tpu.data import parser as jax_parser
from tensor2robot_tpu.data import tfrecord as jax_tfrecord
from tensor2robot_tpu.specs import ExtendedTensorSpec as JaxSpec
from tensor2robot_tpu_torch.data import codec, native, tfrecord
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _specs(shape, dtype=np.uint8, data_format="jpeg"):
    return (JaxSpec(shape=shape, dtype=dtype, name="image", data_format=data_format),
            ExtendedTensorSpec(shape=shape, dtype=dtype, name="image",
                               data_format=data_format))


def _pil_jpeg(array, **kwargs):
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


def _frame(shape=(48, 64), seed=0):
    rng = np.random.RandomState(seed)
    small = rng.randint(0, 256, (shape[0] // 8, shape[1] // 8, 3)).astype(np.uint8)
    frame = np.asarray(Image.fromarray(small).resize(shape[::-1], Image.BILINEAR))
    return np.clip(frame + rng.normal(0, 6, frame.shape), 0, 255).astype(np.uint8)


class TestTFRecord:
    def test_the_codec_built_here_is_libjpeg(self):
        assert native.codec_build()[0] == "libjpeg"
        assert codec.codec_name() == "libjpeg"
        assert not codec.needs_card()

    @pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 63, 1000])
    def test_crc_native_plain_and_jax(self, size):
        data = np.random.RandomState(size).bytes(size)
        want = jax_tfrecord.masked_crc32c(data)
        assert tfrecord.masked_crc32c(data) == want
        assert tfrecord.masked_crc32c_plain(data) == want

    def test_framing_and_streaming_reader(self, tmp_path):
        rng = np.random.RandomState(0)
        records = [rng.bytes(n) for n in (0, 1, 100, 5000, 70000)]
        ours, theirs = tmp_path / "ours.tfrecord", tmp_path / "theirs.tfrecord"
        assert tfrecord.write_tfrecords(str(ours), records) == len(records)
        jax_tfrecord.write_tfrecords(str(theirs), records)
        assert ours.read_bytes() == theirs.read_bytes()
        # A block smaller than a record exercises the partial indexer.
        assert list(tfrecord.read_tfrecords(str(ours), buffer_bytes=64)) == records
        assert tfrecord.count_tfrecords(str(ours)) == len(records)
        offsets, lengths = tfrecord.index_tfrecord_buffer(ours.read_bytes())
        want = jax_tfrecord.index_tfrecord_buffer(ours.read_bytes())
        np.testing.assert_array_equal(offsets, want[0])
        np.testing.assert_array_equal(lengths, want[1])

    def test_corrupt_files_are_refused_alike(self, tmp_path):
        variants = corpus.corrupt_record_variants()
        assert len(variants) > 20
        for name, data in variants.items():
            path = tmp_path / name
            path.write_bytes(data)
            outcomes = []
            for module in (jax_tfrecord, tfrecord):
                try:
                    outcomes.append(("ok", list(module.read_tfrecords(str(path)))))
                except IOError as err:
                    outcomes.append(("refused", type(err).__name__))
            assert outcomes[0][0] == outcomes[1][0], name
            if outcomes[0][0] == "ok":
                assert outcomes[0][1] == outcomes[1][1], name


class TestDecode:
    @pytest.mark.parametrize("subsampling", [0, 2])
    def test_rgb_decode_and_roi(self, subsampling):
        frame = _frame((48, 64))
        data = _pil_jpeg(frame, quality=90, subsampling=subsampling)
        jax_spec, spec = _specs((48, 64, 3))
        full = codec.decode_image(data, spec)
        np.testing.assert_array_equal(full, jax_parser.decode_image(data, jax_spec))
        for y, x, h, w in ((0, 0, 48, 64), (17, 23, 23, 29), (7, 3, 41, 61),
                           (1, 1, 8, 8), (40, 56, 8, 8)):
            got = codec.decode_image_roi(data, spec, y, x, h, w)
            np.testing.assert_array_equal(got, full[y:y + h, x:x + w])
            np.testing.assert_array_equal(
                got, jax_parser.decode_image_roi(data, jax_spec, y, x, h, w))

    def test_progressive_roi_is_the_crop(self):
        data = _pil_jpeg(_frame((40, 56), seed=1), quality=90, progressive=True)
        jax_spec, spec = _specs((40, 56, 3))
        full = codec.decode_image(data, spec)
        np.testing.assert_array_equal(full, jax_parser.decode_image(data, jax_spec))
        np.testing.assert_array_equal(
            codec.decode_image_roi(data, spec, 5, 9, 20, 30), full[5:25, 9:39])

    @pytest.mark.parametrize("shape", [(48, 64, 1), (48, 64)])
    def test_grayscale_specs_take_pils_luma(self, shape):
        jax_spec, spec = _specs(shape)
        colour = _pil_jpeg(_frame((48, 64), seed=2), quality=90)
        grey = _pil_jpeg(_frame((48, 64), seed=3)[..., 0], quality=90)
        for data in (colour, grey):
            np.testing.assert_array_equal(codec.decode_image(data, spec),
                                          jax_parser.decode_image(data, jax_spec))

    def test_float_spec_and_empty_bytes(self):
        jax_spec, spec = _specs((48, 64, 3), dtype=np.float32)
        data = _pil_jpeg(_frame(), quality=90)
        got = codec.decode_image(data, spec)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_parser.decode_image(data, jax_spec))
        zero = codec.decode_image(b"", spec)
        assert zero.shape == (48, 64, 3) and not zero.any()
        assert codec.decode_image_roi(b"", spec, 1, 2, 5, 6).shape == (5, 6, 3)

    def test_wrong_geometry_and_png_raise(self):
        _, spec = _specs((32, 64, 3))
        with pytest.raises(codec.JpegDecodeError, match="does not match"):
            codec.decode_image(_pil_jpeg(_frame(), quality=90), spec)
        with pytest.raises(codec.JpegDecodeError):
            codec.decode_roi_into(_pil_jpeg(_frame(), quality=90),
                                  np.empty((8, 8, 3), np.uint8), 0, 0, (32, 64))
        # PNG (ROADMAP A12, ported): the port's PNG round-trips bit for bit
        # through the port and through the JAX package's PIL decode, and a
        # PNG of another size raises as a JPEG does.
        jax_png, png = _specs((48, 64, 3), data_format="png")
        data = codec.encode_image(_frame(), "png")
        np.testing.assert_array_equal(codec.decode_image(data, png), _frame())
        np.testing.assert_array_equal(jax_parser.decode_image(data, jax_png), _frame())
        with pytest.raises(ValueError, match="does not match"):
            codec.decode_image(data, _specs((32, 64, 3), data_format="png")[1])

    def test_malformed_jpegs_refused_alike(self):
        jax_spec, spec = _specs((24, 32, 3))
        variants = corpus.corrupt_jpeg_variants()
        accepted = 0
        for name, data in variants.items():
            try:
                want = jax_parser.decode_image(data, jax_spec)
            except (ValueError, OSError, SyntaxError):
                want = None
            try:
                got = codec.decode_image(data, spec)
            except ValueError:
                got = None
            assert (want is None) == (got is None), name
            if got is not None:
                accepted += 1
                np.testing.assert_array_equal(got, want, err_msg=name)
        assert accepted >= 2  # the valid and progressive seeds at least


class TestEncode:
    def test_pil_reads_the_ports_jpegs_and_the_bytes_match(self):
        frame = _frame((48, 64), seed=4)
        data = codec.encode_jpeg(frame, quality=95)
        assert data == _pil_jpeg(frame, quality=95)
        decoded = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decoded, codec.decode_image(data, _specs((48, 64, 3))[1]))
        grey = codec.encode_jpeg(frame[..., :1])
        assert Image.open(io.BytesIO(grey)).mode == "L"

    def test_libjpeg_roundtrip_of_the_chip_smoke_frames(self):
        """The libjpeg measurement behind chip_smoke.py's ROUNDTRIP bound:
        q95 of its seeded 512x640 frames, mean and max absolute error."""
        spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
        chip_smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(chip_smoke)
        mean, worst = chip_smoke.codec_roundtrip()
        assert mean == pytest.approx(chip_smoke.LIBJPEG_ROUNDTRIP[0], abs=1e-7)
        assert worst == chip_smoke.LIBJPEG_ROUNDTRIP[1]
        assert mean <= chip_smoke.ROUNDTRIP["libjpeg"][0]
        nv_mean, nv_max = chip_smoke.ROUNDTRIP["nvjpeg"]
        assert nv_mean == pytest.approx(1.5 * mean, abs=1e-6) and nv_max == worst + 32


def test_sof_lies_are_refused():
    data = corpus.valid_jpeg_bytes()
    sof = corpus._find_sof(data)
    lied = bytearray(data)
    lied[sof + 5:sof + 9] = struct.pack(">HH", 4096, 4096)
    with pytest.raises(codec.JpegDecodeError):
        codec.decode_into(bytes(lied), np.empty((24, 32, 3), np.uint8))
