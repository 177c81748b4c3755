"""Port parity: tensor2robot_tpu_torch.data.input_generators and
make_constant_numpy vs the JAX package.

For the same model specs and seed, every batch must be byte-identical to
the JAX generator's: same keys in the same order, same dtypes, same
shapes, same bytes.
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu.data import input_generators as jax_generators
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.specs import make_constant_numpy as jax_make_constant_numpy
from tensor2robot_tpu_torch.data import input_generators as generators
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    make_constant_numpy,
)

SMALL = dict(
    action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
    d_model=32, num_layers=2, num_heads=2, head_dim=16, use_flash=True,
)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def models():
    return (
        jax_models.TransformerBCModel(interpret=True, device_type="cpu", **SMALL),
        TransformerBCModel(**SMALL),
    )


def _assert_batches_equal(ours, theirs):
    assert list(ours.keys()) == list(theirs.keys())
    for key in ours:
        a, b = np.asarray(ours[key]), np.asarray(theirs[key])
        assert a.dtype == b.dtype, key
        assert a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


def _episodes():
    rng = np.random.RandomState(3)
    for _ in range(7):
        yield {
            "features/image": rng.rand(16, 16, 16, 3).astype(np.float32),
            "features/gripper_pose": rng.rand(16, 14).astype(np.float32),
            "labels/action": rng.rand(16, 7).astype(np.float32),
        }


GENERATORS = {
    "random": lambda m: m.DefaultRandomInputGenerator(batch_size=3, seed=11),
    "constant": lambda m: m.DefaultConstantInputGenerator(
        constant_value=0.25, batch_size=2
    ),
    "python_generator": lambda m: m.GeneratorInputGenerator(_episodes, batch_size=3),
}


class TestBatchesMatchJax:
    @pytest.mark.parametrize("mode", ["train", "eval", "predict"])
    @pytest.mark.parametrize("kind", list(GENERATORS), ids=list(GENERATORS))
    def test_byte_identical(self, models, kind, mode):
        jax_model, model = models
        theirs = GENERATORS[kind](jax_generators)
        ours = GENERATORS[kind](generators)
        theirs.set_specification_from_model(jax_model, mode)
        ours.set_specification_from_model(model, mode)
        jax_batches = list(zip(range(3), theirs.create_dataset(mode)))
        batches = list(zip(range(3), ours.create_dataset(mode)))
        assert len(batches) == len(jax_batches)
        for (_, a), (_, b) in zip(batches, jax_batches):
            _assert_batches_equal(a, b)

    def test_generator_drops_the_short_last_batch(self, models):
        _, model = models
        ours = generators.GeneratorInputGenerator(_episodes, batch_size=3)
        ours.set_specification_from_model(model, "train")
        assert len(list(ours.create_dataset("train"))) == 2  # 7 // 3

    def test_random_batches_follow_the_seed(self, models):
        _, model = models
        ours = generators.DefaultRandomInputGenerator(batch_size=2, seed=5)
        ours.set_specification_from_model(model, "train")
        first, second = (b for _, b in zip(range(2), ours.create_dataset("train")))
        again = generators.DefaultRandomInputGenerator(batch_size=2, seed=6)
        again.set_specification_from_model(model, "train")
        _assert_batches_equal(second, next(iter(again.create_dataset("train"))))
        assert not np.array_equal(first["features/image"], second["features/image"])


class TestGeneratorContract:
    def test_specs_must_be_set(self):
        ours = generators.DefaultRandomInputGenerator()
        with pytest.raises(ValueError, match="Specs not set"):
            ours.feature_spec
        with pytest.raises(ValueError, match="Specs not set"):
            next(iter(ours.create_dataset("train")))

    def test_mode_is_checked(self, models):
        _, model = models
        ours = generators.DefaultRandomInputGenerator()
        ours.set_specification_from_model(model, "train")
        with pytest.raises(ValueError, match="mode must be one of"):
            ours.create_dataset("serve")

    def test_batches_are_packed_by_subtree(self, models):
        _, model = models
        ours = generators.DefaultRandomInputGenerator(batch_size=2)
        ours.set_specification_from_model(model, "train")
        batch = next(iter(ours.create_dataset("train")))
        assert set(batch["features"].keys()) == {"image", "gripper_pose"}
        assert batch["labels"]["action"].shape == (2, 16, 7)
        assert ours.batch_size == 2

class TestMakeConstantNumpy:
    @pytest.mark.parametrize("batch_size", [None, 1, 3])
    def test_byte_identical_to_jax(self, models, batch_size):
        jax_model, model = models
        for mode in ("train", "predict"):
            for getter in ("get_feature_specification", "get_label_specification"):
                ours = make_constant_numpy(
                    getattr(model, getter)(mode), constant_value=0.5,
                    batch_size=batch_size, sequence_length=4,
                )
                theirs = jax_make_constant_numpy(
                    getattr(jax_model, getter)(mode), constant_value=0.5,
                    batch_size=batch_size, sequence_length=4,
                )
                _assert_batches_equal(ours, theirs)

    def test_dtypes_of_other_specs(self):
        from tensor2robot_tpu.specs import ExtendedTensorSpec as JaxSpec
        from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct

        kinds = {"u8": np.uint8, "i64": np.int64, "flag": np.bool_, "f16": np.float16}
        ours = TensorSpecStruct({
            k: ExtendedTensorSpec(shape=(2,), dtype=d, name=k) for k, d in kinds.items()
        })
        theirs = JaxStruct({
            k: JaxSpec(shape=(2,), dtype=d, name=k) for k, d in kinds.items()
        })
        _assert_batches_equal(
            make_constant_numpy(ours, constant_value=1),
            jax_make_constant_numpy(theirs, constant_value=1),
        )
