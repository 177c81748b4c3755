"""PoseToyEnv episode -> transition Examples.

Port of tensor2robot_tpu/research/pose_env/episode_to_transitions.py: the
supervised pose-regression layout — JPEG state image, attempted pose,
reward, true target pose. The JAX package builds protobuf Examples and
encodes the image with PIL; the port writes the Example wire format with
its own encoder (data/encoder.py) and the image with its own codec at
PIL's default quality (utils/image.py). Float features are bit-equal to
the JAX package's; the JPEG bytes are not, their decoded pixels agree
within the codec's round-trip error.
"""

from __future__ import annotations

import numpy as np

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.data.encoder import encode_example
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct
from tensor2robot_tpu_torch.utils import image as image_lib


def _float_spec(name: str, size: int) -> ExtendedTensorSpec:
    return ExtendedTensorSpec(shape=(size,), dtype=np.float32, name=name)


@configurable("episode_to_transitions_pose_toy")
def episode_to_transitions_pose_toy(
    episode_data, binary_success_threshold=None
):
    """Converts pose toy env episodes to serialized transition Examples.

    Args:
      episode_data: (obs, action, reward, new_obs, done, debug) tuples.
      binary_success_threshold: if set, rewards are relabeled to
        1.0 when above the threshold else 0.0 — giving the downstream
        reward-weighted losses proper non-negative sample weights (the
        env's raw reward is a negative distance).
    """
    transitions = []
    for transition in episode_data:
        obs_t, action, reward, _, _, debug = transition
        if binary_success_threshold is not None:
            reward = float(reward > binary_success_threshold)
        pose = np.asarray(action, np.float32).reshape(-1)
        target = np.asarray(debug["target_pose"], np.float32).reshape(-1)
        spec = TensorSpecStruct()
        spec["state/image"] = ExtendedTensorSpec(
            shape=tuple(np.shape(obs_t)), dtype=np.uint8, name="state/image",
            data_format="jpeg",
        )
        spec["pose"] = _float_spec("pose", pose.size)
        spec["reward"] = _float_spec("reward", 1)
        spec["target_pose"] = _float_spec("target_pose", target.size)
        values = {
            "state/image": image_lib.numpy_to_image_string(obs_t, "jpeg"),
            "pose": pose,
            "reward": np.array([reward], np.float32),
            "target_pose": target,
        }
        transitions.append(encode_example(spec, values))
    return transitions
