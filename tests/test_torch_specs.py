"""Port parity: tensor2robot_tpu_torch.specs vs the JAX package's specs.

The same spec structures go through both packages: flattening, copying
with a batch dim and a name prefix, fixture generation from a seed,
validation and packing of numpy arrays (and, in the port, torch tensors).
"""

import numpy as np
import pytest
import torch

from tensor2robot_tpu import specs as jax_specs
from tensor2robot_tpu_torch import specs


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _structure(pkg):
    """A nested spec structure with every field the port keeps."""
    spec = pkg.ExtendedTensorSpec
    return {
        "train": {
            "image": spec(shape=(8, 8, 3), dtype=np.uint8, name="image",
                          data_format="jpeg"),
            "pose": spec(shape=(7,), dtype=np.float32, name="pose"),
        },
        "step": spec(shape=(), dtype=np.int64, name="step"),
        "mask": spec(shape=(4,), dtype=np.bool_, name="mask", is_optional=True),
        "seq": spec(shape=(2,), dtype=np.float32, name="seq", is_sequence=True),
    }


def _describe(flat):
    return {
        key: (
            tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""),
            leaf.name, leaf.is_optional, leaf.is_sequence, leaf.data_format,
        )
        for key, leaf in flat.items()
    }


class TestSpecParity:
    def test_flatten(self):
        assert _describe(specs.flatten_spec_structure(_structure(specs))) == (
            _describe(jax_specs.flatten_spec_structure(_structure(jax_specs)))
        )

    @pytest.mark.parametrize(
        "kw", [dict(), dict(batch_size=5), dict(batch_size=-1, prefix="ep")]
    )
    def test_copy_tensorspec(self, kw):
        assert _describe(specs.copy_tensorspec(_structure(specs), **kw)) == (
            _describe(jax_specs.copy_tensorspec(_structure(jax_specs), **kw))
        )

    def test_filter_required(self):
        assert _describe(
            specs.filter_required_flat_tensor_spec(_structure(specs))
        ) == _describe(
            jax_specs.filter_required_flat_tensor_spec(_structure(jax_specs))
        )

    @pytest.mark.parametrize("seed,batch", [(0, 2), (3, None), (11, 4)])
    def test_make_random_numpy_draws_the_same_values(self, seed, batch):
        ours = specs.make_random_numpy(
            _structure(specs), batch_size=batch, seed=seed
        )
        theirs = jax_specs.make_random_numpy(
            _structure(jax_specs), batch_size=batch, seed=seed
        )
        assert list(ours) == list(theirs)
        for key in ours:
            np.testing.assert_array_equal(ours[key], theirs[key])
            assert ours[key].dtype == theirs[key].dtype

    def test_name_collision_rejected_by_both(self):
        for pkg in (specs, jax_specs):
            spec = pkg.ExtendedTensorSpec
            with pytest.raises(ValueError, match="collision"):
                pkg.flatten_spec_structure({
                    "a": spec(shape=(1,), dtype=np.float32, name="x"),
                    "b": spec(shape=(2,), dtype=np.float32, name="x"),
                })


class TestValidation:
    def _tensors(self, pkg, batch=3):
        return pkg.make_random_numpy(_structure(pkg), batch_size=batch, seed=1)

    def test_pack_numpy_and_torch(self):
        struct = _structure(specs)
        arrays = dict(self._tensors(specs).items())
        packed = specs.validate_and_pack(struct, arrays, ignore_batch=True)
        theirs = jax_specs.validate_and_pack(
            _structure(jax_specs), dict(self._tensors(jax_specs).items()),
            ignore_batch=True,
        )
        assert list(packed) == list(theirs)
        tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
        packed_t = specs.validate_and_pack(struct, tensors, ignore_batch=True)
        assert list(packed_t) == list(packed)
        assert isinstance(packed_t.train.image, torch.Tensor)

    def test_optional_may_be_missing_and_extras_dropped(self):
        arrays = dict(self._tensors(specs).items())
        del arrays["mask"]
        arrays["extra"] = np.zeros((3, 1), np.float32)
        flat = specs.validate_and_flatten(_structure(specs), arrays, ignore_batch=True)
        assert "mask" not in flat and "extra" not in flat

    @pytest.mark.parametrize(
        "key,bad",
        [
            ("train/pose", np.zeros((3, 6), np.float32)),
            ("train/pose", np.zeros((3, 7), np.float64)),
            ("step", np.zeros((3, 1), np.int64)),
        ],
        ids=["shape", "dtype", "rank"],
    )
    def test_mismatch_raises_in_both(self, key, bad):
        for pkg in (specs, jax_specs):
            arrays = dict(self._tensors(pkg).items())
            arrays[key] = bad
            with pytest.raises(ValueError, match="mismatch"):
                pkg.validate_and_pack(_structure(pkg), arrays, ignore_batch=True)

    def test_missing_required_raises(self):
        arrays = dict(self._tensors(specs).items())
        del arrays["step"]
        with pytest.raises(ValueError, match="Required"):
            specs.validate_and_pack(_structure(specs), arrays, ignore_batch=True)


class TestSpecAndStruct:
    @pytest.mark.parametrize(
        "dtype,want",
        [
            (np.float32, torch.float32),
            ("float32", torch.float32),
            (torch.int64, torch.int64),
            ("bfloat16", torch.bfloat16),
            (np.dtype(np.uint8), torch.uint8),
        ],
    )
    def test_canonical_dtype(self, dtype, want):
        assert specs.canonical_dtype(dtype) == want

    def test_equality_is_shape_and_dtype(self):
        a = specs.ExtendedTensorSpec(shape=(2,), dtype=np.float32, name="a")
        b = specs.ExtendedTensorSpec(shape=[2], dtype=torch.float32, name="b")
        assert a == b and hash(a) == hash(b)
        assert a != specs.ExtendedTensorSpec(shape=(3,), dtype=np.float32)

    def test_bad_fields_raise(self):
        with pytest.raises(ValueError, match="data_format"):
            specs.ExtendedTensorSpec(shape=(1,), dtype=np.uint8, data_format="gif")
        with pytest.raises(ValueError, match="varlen"):
            specs.ExtendedTensorSpec(
                shape=(None,), dtype=np.float32, varlen_default_value=0.0
            )
        with pytest.raises(TypeError, match="numpy counterpart"):
            specs.numpy_dtype(torch.bfloat16)

    def test_struct_views_write_through(self):
        for pkg in (specs, jax_specs):
            struct = pkg.TensorSpecStruct()
            struct["a/b"] = 1
            view = struct.a
            view.c = 2
            assert list(struct.keys()) == ["a/b", "a/c"]
            assert dict(view.items()) == {"b": 1, "c": 2}
            with pytest.raises(ValueError, match="collides"):
                struct["a/b/d"] = 3
            with pytest.raises(ValueError, match="empty"):
                struct.e = {}
            assert struct.to_hierarchical_dict() == {"a": {"b": 1, "c": 2}}
