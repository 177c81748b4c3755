"""Episode -> transition record converters for replay writing.

Port of tensor2robot_tpu/research/vrgripper/episode_to_transitions.py.
Transitions are (obs, action, reward, next_obs, done, debug) tuples. The
JAX package builds protobuf Example / SequenceExample messages; the port
writes their wire format with its own encoder (data/encoder.py) and
returns the serialized records: a parser reads back the same features
(the map keys may come in another order than protobuf writes them).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.data.encoder import encode_example
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct


@configurable("make_fixed_length")
def make_fixed_length(
    input_list: Sequence,
    fixed_length: int,
    always_include_endpoints: bool = True,
    randomized: bool = True,
    rng: Optional[np.random.RandomState] = None,
) -> Optional[List]:
    """A fixed-length subsample of a list, keeping its endpoints by
    default; None for lists of length <= 2."""
    original_length = len(input_list)
    if original_length <= 2:
        return None
    if not randomized:
        indices = np.sort(np.mod(np.arange(fixed_length), original_length))
        return [input_list[i] for i in indices]
    rng = rng or np.random
    if always_include_endpoints:
        endpoint_indices = np.array([0, original_length - 1])
        other_indices = 1 + rng.choice(original_length - 2, fixed_length - 2, replace=True)
        indices = np.concatenate((endpoint_indices, other_indices), axis=0)
    else:
        indices = rng.choice(original_length, fixed_length, replace=True)
    return [input_list[i] for i in np.sort(indices)]


def _spec(name: str, size: int, dtype=np.float32, is_sequence: bool = False):
    return ExtendedTensorSpec(shape=(size,), dtype=dtype, name=name, is_sequence=is_sequence)


@configurable("episode_to_transitions_reacher")
def episode_to_transitions_reacher(episode_data, is_demo: bool = False) -> List[bytes]:
    """One serialized Example per transition: pose_t, pose_tp1, action,
    reward (floats), done and is_demo (int64)."""
    transitions = []
    for obs_t, action, reward, obs_tp1, done, _ in episode_data:
        obs_t, obs_tp1 = np.asarray(obs_t, np.float32), np.asarray(obs_tp1, np.float32)
        action = np.asarray(action, np.float32).reshape(-1)
        spec = TensorSpecStruct(
            pose_t=_spec("pose_t", obs_t.size), pose_tp1=_spec("pose_tp1", obs_tp1.size),
            action=_spec("action", action.size), reward=_spec("reward", 1),
            done=_spec("done", 1, np.int64), is_demo=_spec("is_demo", 1, np.int64))
        transitions.append(encode_example(spec, {
            "pose_t": obs_t.reshape(-1), "pose_tp1": obs_tp1.reshape(-1), "action": action,
            "reward": np.array([reward], np.float32),
            "done": np.array([int(done)], np.int64),
            "is_demo": np.array([int(is_demo)], np.int64)}))
    return transitions


@configurable("episode_to_transitions_metareacher")
def episode_to_transitions_metareacher(episode_data) -> List[bytes]:
    """One serialized SequenceExample per episode: is_demo and target_idx
    in its context, per-step pose_t, pose_tp1, action, reward and done
    feature lists."""
    debug = episode_data[0][-1]
    obs_t, action = (np.asarray(episode_data[0][i], np.float32).reshape(-1) for i in (0, 1))
    obs_tp1 = np.asarray(episode_data[0][3], np.float32).reshape(-1)
    spec = TensorSpecStruct(
        is_demo=_spec("is_demo", 1, np.int64), target_idx=_spec("target_idx", 1, np.int64),
        pose_t=_spec("pose_t", obs_t.size, is_sequence=True),
        pose_tp1=_spec("pose_tp1", obs_tp1.size, is_sequence=True),
        action=_spec("action", action.size, is_sequence=True),
        reward=_spec("reward", 1, is_sequence=True),
        done=_spec("done", 1, np.int64, is_sequence=True))
    steps = list(zip(*[(np.asarray(t[0], np.float32).reshape(-1),
                        np.asarray(t[3], np.float32).reshape(-1),
                        np.asarray(t[1], np.float32).reshape(-1),
                        np.array([t[2]], np.float32), np.array([int(t[4])], np.int64))
                       for t in episode_data]))
    values = {"is_demo": np.array([int(debug["is_demo"])], np.int64),
              "target_idx": np.array([debug["target_idx"]], np.int64)}
    for key, column in zip(("pose_t", "pose_tp1", "action", "reward", "done"), steps):
        values[key] = np.stack(column)
    return [encode_example(spec, values)]
