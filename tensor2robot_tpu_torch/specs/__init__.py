"""Spec system: typed tensor contracts and the flat/hierarchical container."""

from tensor2robot_tpu_torch.specs.spec import (
    ExtendedTensorSpec,
    canonical_dtype,
    is_leaf,
    numpy_dtype,
)
from tensor2robot_tpu_torch.specs.struct import TensorSpecStruct
from tensor2robot_tpu_torch.specs.utils import (
    assert_equal_spec_or_tensor,
    assert_required,
    copy_tensorspec,
    filter_required_flat_tensor_spec,
    flatten_spec_structure,
    make_constant_numpy,
    make_random_numpy,
    validate_and_flatten,
    validate_and_pack,
)
