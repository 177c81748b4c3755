"""Port parity: the T2RAssets sidecar written and read without protobuf.

The port writes assets.extra/t2r_assets.pbtxt by hand (specs/proto_io.py).
For the BC and critic serving specs and for a spec with every field set,
its file must be byte-equal to the JAX package's (protobuf's
text_format.MessageToString), and each package must read the other's
file back to the same specs, label specs and global step.
"""

import os

import numpy as np
import pytest
import torch

from tensor2robot_tpu.export.export_generators import (
    DefaultExportGenerator as JaxExportGenerator,
)
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.research.qtopt import t2r_models as jax_qtopt
from tensor2robot_tpu.specs import ExtendedTensorSpec as JaxSpec
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu.specs import proto_io as jax_proto_io
from tensor2robot_tpu_torch.export import DefaultExportGenerator
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.research.qtopt import t2r_models
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct
from tensor2robot_tpu_torch.specs import proto_io

BC = dict(episode_length=16, image_size=(16, 16), d_model=32, num_layers=2,
          num_heads=2, head_dim=16)
CRITIC = dict(image_size=(96, 96), num_convs=(2, 2, 1))
FIELDS = ("shape", "name", "is_optional", "is_extracted", "is_sequence",
          "data_format", "dataset_key", "varlen_default_value")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _serving_specs(jax_model, model):
    jax_gen, gen = JaxExportGenerator(), DefaultExportGenerator()
    jax_gen.set_specification_from_model(jax_model)
    gen.set_specification_from_model(model)
    return ((jax_gen.serving_input_spec(), jax_gen.label_spec),
            (gen.serving_input_spec(), gen.label_spec))


def _every_field():
    """Both packages' structs of specs that set every field, with
    strings that need escapes and float32 values of every print form."""
    jax_struct, struct = JaxStruct(), TensorSpecStruct()
    values = (0.1, 0.0, -0.0, 1e-30, 123456789.0, -3.5e38, float("inf"),
              1e20, 5.0, 1 / 3, 1e-45, 3.4028235e38, -2.5)
    for i, value in enumerate(values):
        kw = dict(
            shape=(5,), dtype=np.float32,
            name=f'n"\x01\x7f\t\\é{i}',
            is_optional=bool(i % 2), is_extracted=i % 3 == 0,
            is_sequence=i % 4 == 0, data_format=("jpeg", None)[i % 2],
            dataset_key="dk'" if i % 5 else "", varlen_default_value=value,
        )
        jax_struct[f"z{i}/x"] = JaxSpec(**kw)
        struct[f"z{i}/x"] = ExtendedTensorSpec(**kw)
    for key, shape, dtype in (("a", (None, 2, 3), np.uint8),
                              ("b", (), "bfloat16"), ("c", (1,), np.bool_),
                              ("d", (4, None), np.int64)):
        jax_struct[key] = JaxSpec(shape=shape, dtype=dtype, name=key)
        struct[key] = ExtendedTensorSpec(shape=shape, dtype=dtype, name=key)
    return (jax_struct, jax_struct), (struct, struct)


CASES = {
    "bc": lambda: _serving_specs(
        jax_models.TransformerBCModel(device_type="cpu", **BC),
        TransformerBCModel(**BC)),
    "critic": lambda: _serving_specs(
        jax_qtopt.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
            **CRITIC),
        t2r_models.Grasping44E2EOpenCloseTerminateGripperStatusHeightToBottom(
            **CRITIC)),
    "every_field": _every_field,
}


def _same(ours, theirs):
    assert list(ours) == list(theirs)
    for key in ours:
        for field in FIELDS:
            assert getattr(ours[key], field) == getattr(theirs[key], field), (
                key, field)
        assert ours[key] == theirs[key]  # shape and dtype


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("step", [0, 123])
def test_file_is_byte_equal_to_jax(tmp_path, case, step):
    (jax_features, jax_labels), (features, labels) = CASES[case]()
    jax_path = jax_proto_io.write_t2r_assets(
        str(tmp_path / "jax"), jax_features, label_spec=jax_labels,
        global_step=step)
    path = proto_io.write_t2r_assets(
        str(tmp_path / "port"), features, label_spec=labels, global_step=step)
    assert path.endswith(os.path.join("assets.extra", "t2r_assets.pbtxt"))
    with open(jax_path, "rb") as f:
        want = f.read()
    with open(path, "rb") as f:
        assert f.read() == want
    assert not os.path.exists(path + ".tmp")


@pytest.mark.parametrize("case", list(CASES))
def test_each_package_reads_the_others_file(tmp_path, case):
    (jax_features, jax_labels), (features, labels) = CASES[case]()
    jax_proto_io.write_t2r_assets(
        str(tmp_path / "jax"), jax_features, label_spec=jax_labels,
        global_step=7)
    proto_io.write_t2r_assets(
        str(tmp_path / "port"), features, label_spec=labels, global_step=7)
    ours = proto_io.read_t2r_assets(str(tmp_path / "jax"))
    theirs = jax_proto_io.read_t2r_assets(str(tmp_path / "port"))
    reference = jax_proto_io.read_t2r_assets(str(tmp_path / "jax"))
    for got in (ours, theirs):
        _same(got[0], reference[0])
        assert (got[1] is None) == (reference[1] is None)
        if reference[1] is not None:
            _same(got[1], reference[1])
        assert got[2] == reference[2] == 7


def test_no_label_spec_and_reading_protobuf_variants(tmp_path):
    struct = TensorSpecStruct(x=ExtendedTensorSpec(shape=(3,), dtype=np.float32))
    text = proto_io.assets_to_text(struct)
    assert "label_spec" not in text and "global_step" not in text
    features, labels, step = proto_io.assets_from_text(
        "# comment\nfeature_spec < keys: 'x' key_value { key: \"x\" "
        "value: { shape: [3] dtype: \"float32\" name: \"a\" \"b\" "
        "has_varlen_default_value: true varlen_default_value: 1.5f } } >\n"
        "label_spec {}\nglobal_step: 0x10\n"
    )
    assert labels is None and step == 16
    assert features["x"].name == "ab" and features["x"].varlen_default_value == 1.5
    with pytest.raises(ValueError, match="unknown fields"):
        proto_io.assets_from_text("feature_spec { bogus: 1 }")
