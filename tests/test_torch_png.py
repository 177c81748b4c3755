"""The port's PNG codec (data/png.py, data/csrc/png_unfilter.cc) against
PIL and the JAX package's PIL path, bit for bit.

  * PIL-encoded files of every supported colour type and bit depth (L,
    LA, RGB, RGBA, palette at 1/2/4/8 bits, 1-bit greyscale): the port's
    RGB and L conversions equal PIL's convert("RGB") and convert("L").
  * The port's encoder over each filter type 0-4, plain and Adam7, at
    sizes that leave Adam7 passes empty: PIL decodes the source back
    exactly, and so does the port; palettes at 1/2/4/8 bits too.
  * The native unfilter equals the numpy one on random scanlines for
    every filter and 1-4 bytes per pixel.
  * Records: the JAX package's parser (PIL) and the port's wire parser
    read the port's PNG records alike, RGB and greyscale specs, ROI
    crops equal the full decode's window, and RecordDataset batches of PNG
    records equal the JAX RecordDataset's.
  * 16-bit PNGs raise NotImplementedError naming A12(b); empty bytes give
    the zero image; a size mismatch, a CRC flip, a truncation and an
    unknown filter type raise PngDecodeError.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from tensor2robot_tpu.data import dataset as jax_dataset
from tensor2robot_tpu.data import parser as jax_parser
from tensor2robot_tpu.data import tfrecord as jax_tfrecord
from tensor2robot_tpu.specs import ExtendedTensorSpec as JaxSpec
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu_torch.data import codec, dataset, encoder, png
from tensor2robot_tpu_torch.data.parser import SpecParser
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct

SIZES = [(1, 1), (5, 7), (13, 9), (24, 32)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _pixels(hw, channels, seed=0):
    rng = np.random.RandomState(seed)
    shape = tuple(hw) + ((channels,) if channels > 1 else ())
    # Smooth ramps plus noise, so every filter predicts something.
    ramp = (np.add.outer(np.arange(hw[0]) * 7, np.arange(hw[1]) * 3) % 256)
    ramp = ramp.reshape(tuple(hw) + (1,) * (len(shape) - 2))
    return ((ramp + rng.randint(0, 40, shape)) % 256).astype(np.uint8)


def _pil_png(image, **kwargs):
    buf = io.BytesIO()
    image.save(buf, format="PNG", **kwargs)
    return buf.getvalue()


def _pil(data):
    return Image.open(io.BytesIO(data))


def _assert_port_reads_like_pil(data):
    image = png.decode_png(data)
    np.testing.assert_array_equal(png.to_rgb(image), np.asarray(_pil(data).convert("RGB")))
    np.testing.assert_array_equal(png.to_luma(image), np.asarray(_pil(data).convert("L")))
    return image


def _pil_cases():
    cases = {}
    for hw in SIZES:
        for mode, channels in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
            cases[f"{mode}-{hw}"] = _pil_png(Image.fromarray(_pixels(hw, channels), mode))
        rgb = Image.fromarray(_pixels(hw, 3, seed=1), "RGB")
        for bits in (1, 2, 4, 8):
            paletted = rgb.quantize(colors=1 << bits)
            cases[f"P{bits}-{hw}"] = _pil_png(paletted, bits=bits)
        cases[f"1-{hw}"] = _pil_png(Image.fromarray(_pixels(hw, 1) > 128))
    return cases


PIL_CASES = _pil_cases()


@pytest.mark.parametrize("name", sorted(PIL_CASES))
def test_pil_encoded_files_decode_as_pil(name):
    data = PIL_CASES[name]
    image = _assert_port_reads_like_pil(data)
    if name.startswith("P"):
        assert image.color_type == 3
        np.testing.assert_array_equal(image.samples[..., 0], np.asarray(_pil(data)))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_port_encode_round_trips_through_pil_and_the_port(filter_type, interlace,
                                                          channels):
    for hw in SIZES:
        source = _pixels(hw, channels, seed=filter_type)
        data = png.encode_png(source, filter_type=filter_type, interlace=interlace)
        np.testing.assert_array_equal(np.asarray(_pil(data)), source)
        image = _assert_port_reads_like_pil(data)
        np.testing.assert_array_equal(image.samples.reshape(source.shape), source)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
def test_port_encoded_palettes_read_as_pil(bits, interlace):
    rng = np.random.RandomState(bits)
    palette = rng.randint(0, 256, (1 << bits, 3)).astype(np.uint8)
    for filter_type in range(5):
        for hw in SIZES:
            indices = rng.randint(0, 1 << bits, hw).astype(np.uint8)
            data = png.encode_png(indices, filter_type=filter_type, interlace=interlace,
                                  palette=palette, bit_depth=bits)
            np.testing.assert_array_equal(np.asarray(_pil(data)), indices)
            image = _assert_port_reads_like_pil(data)
            np.testing.assert_array_equal(png.to_rgb(image), palette[indices])


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_native_unfilter_equals_numpy(bpp, filter_type):
    rng = np.random.RandomState(bpp * 10 + filter_type)
    height, row_bytes = 9, 7 * bpp
    rows = rng.randint(0, 256, (height, row_bytes + 1)).astype(np.uint8)
    rows[:, 0] = filter_type
    rows[::3, 0] = (filter_type + 1) % 5  # mixed filters across rows
    data = rows.tobytes()
    np.testing.assert_array_equal(png.unfilter(data, height, row_bytes, bpp),
                                  png.unfilter_numpy(data, height, row_bytes, bpp))


def test_decode_with_the_numpy_unfilter_equals_the_native():
    for interlace in (False, True):
        data = png.encode_png(_pixels((13, 9), 3), filter_type=4, interlace=interlace)
        np.testing.assert_array_equal(
            png.decode_png(data).samples,
            png.decode_png(data, unfilter_fn=png.unfilter_numpy).samples)


def _specs(shape, dtype=np.uint8):
    return (JaxSpec(shape=shape, dtype=dtype, name="image", data_format="png"),
            ExtendedTensorSpec(shape=shape, dtype=dtype, name="image", data_format="png"))


@pytest.mark.parametrize("shape", [(24, 32, 3), (24, 32, 1), (24, 32)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_codec_decode_image_equals_the_jax_parser(shape, dtype):
    jax_spec, spec = _specs(shape, dtype)
    sources = [_pixels((24, 32), c, seed=c) for c in (1, 2, 3, 4)]
    for source in sources:
        data = codec.encode_image(source, "png")
        got = codec.decode_image(data, spec)
        assert got.dtype == np.dtype(dtype) and got.shape == shape
        np.testing.assert_array_equal(got, jax_parser.decode_image(data, jax_spec))
    for data in (PIL_CASES["P4-(24, 32)"], PIL_CASES["1-(24, 32)"]):
        np.testing.assert_array_equal(codec.decode_image(data, spec),
                                      jax_parser.decode_image(data, jax_spec))


def test_roi_decode_is_the_crop_of_the_full_decode():
    _, spec = _specs((24, 32, 3))
    data = codec.encode_image(_pixels((24, 32), 3), "png")
    full = codec.decode_image(data, spec)
    for y, x, th, tw in ((0, 0, 24, 32), (3, 5, 8, 9), (16, 23, 8, 9)):
        np.testing.assert_array_equal(codec.decode_image_roi(data, spec, y, x, th, tw),
                                      full[y:y + th, x:x + tw])
        out = np.empty((th, tw, 3), np.uint8)
        codec.decode_roi_into(data, out, y, x, (24, 32))
        np.testing.assert_array_equal(out, full[y:y + th, x:x + tw])


def _records(count, seed=0):
    jax_spec, spec = JaxStruct(), TensorSpecStruct()
    layout = {
        "features/image": dict(shape=(24, 32, 3), dtype=np.uint8, name="image",
                               data_format="png"),
        "features/grey": dict(shape=(24, 32, 1), dtype=np.uint8, name="grey",
                              data_format="png"),
        "labels/reward": dict(shape=(1,), dtype=np.float32, name="reward"),
    }
    for key, kwargs in layout.items():
        jax_spec[key] = JaxSpec(**kwargs)
        spec[key] = ExtendedTensorSpec(**kwargs)
    rng = np.random.RandomState(seed)
    records = []
    for i in range(count):
        values = TensorSpecStruct()
        values["features/image"] = _pixels((24, 32), 3, seed=seed * 100 + i)
        values["features/grey"] = _pixels((24, 32), 1, seed=seed * 100 + i + 50)[..., None]
        values["labels/reward"] = rng.rand(1).astype(np.float32)
        records.append(encoder.encode_example(spec, values))
    return jax_spec, spec, records


def test_parsers_read_the_ports_png_records_alike():
    jax_spec, spec, records = _records(6)
    want = jax_parser.SpecParser(jax_spec).parse_batch(records)
    got = SpecParser(spec).parse_batch(records)
    assert set(want.keys()) == set(got.keys())
    for key in want.keys():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]),
                                      err_msg=key)


def test_record_dataset_batches_of_png_records_equal_jax(tmp_path):
    jax_spec, spec, records = _records(12, seed=1)
    path = str(tmp_path / "png.tfrecord")
    jax_tfrecord.write_tfrecords(path, records)
    common = dict(batch_size=4, mode="eval", seed=2, num_parse_workers=2, prefetch_depth=1)
    want = list(jax_dataset.RecordDataset(jax_spec, path, **common))
    got = list(dataset.RecordDataset(spec, path, **common))
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        for key in a.keys():
            np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]), err_msg=key)


def test_sixteen_bit_raises_naming_its_item():
    data = _pil_png(Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 5000))
    assert _pil(data).mode.startswith("I")
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md A12\(b\)"):
        png.decode_png(data)
    _, spec = _specs((3, 4, 1))
    with pytest.raises(NotImplementedError, match=r"A12\(b\)"):
        codec.decode_image(data, spec)


def test_empty_bytes_give_the_zero_image():
    _, spec = _specs((24, 32, 3), np.float32)
    zero = codec.decode_image(b"", spec)
    assert zero.shape == (24, 32, 3) and zero.dtype == np.float32 and not zero.any()


def test_malformed_streams_raise():
    _, spec = _specs((24, 32, 3))
    data = codec.encode_image(_pixels((24, 32), 3), "png")
    with pytest.raises(png.PngDecodeError, match="does not match"):
        codec.decode_image(data, _specs((24, 31, 3))[1])
    with pytest.raises(png.PngDecodeError, match="does not match"):
        codec.decode_into(data, np.empty((8, 8, 3), np.uint8))
    flipped = bytearray(data)
    flipped[40] ^= 0xFF
    with pytest.raises(png.PngDecodeError):
        codec.decode_image(bytes(flipped), spec)
    with pytest.raises(png.PngDecodeError):
        codec.decode_image(data[:len(data) // 2], spec)
    rows = np.zeros((2, 4), np.uint8)
    rows[1, 0] = 7
    with pytest.raises(png.PngDecodeError, match="filter type"):
        png.unfilter(rows.tobytes(), 2, 3, 1)
    with pytest.raises(png.PngDecodeError, match="short"):
        png.unfilter(rows.tobytes()[:5], 2, 3, 1)


def test_codec_counts_png_decodes_and_encodes():
    _, spec = _specs((24, 32, 3))
    codec.COUNTS.reset()
    data = codec.encode_image(_pixels((24, 32), 3), "png")
    codec.decode_image(data, spec)
    assert (codec.COUNTS.png_encodes, codec.COUNTS.png_decodes, codec.COUNTS.decodes) == (
        1, 1, 0)
