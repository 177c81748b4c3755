"""Episode runner: drives a gym-style env with a policy, writes transitions.

Port of tensor2robot_tpu/research/run_env.py, host Python: the
collect/eval workhorse — explore-probability schedule, episode ->
transitions conversion, replay-writer sink, per-episode reward
accounting. Environments are any object with `reset() -> obs` and
`step(action) -> (obs, reward, done, info)` (old-gym protocol; 5-tuple
new-gym returns are also accepted).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.utils import writer as writer_lib


@dataclasses.dataclass
class Transition:
    obs: Any
    action: np.ndarray
    reward: float
    new_obs: Any
    done: bool
    debug: Optional[dict] = None

    def __iter__(self):
        # Tuple-unpacking compatibility with the reference's
        # (obs, action, rew, new_obs, done, debug) episode tuples.
        return iter(
            (self.obs, self.action, self.reward, self.new_obs, self.done,
             self.debug)
        )


def episode_to_transitions_identity(episode: List[Transition]) -> List[Transition]:
    return episode


def _step_env(env, action) -> Tuple[Any, float, bool, dict]:
    result = env.step(action)
    if len(result) == 5:  # new-gym: obs, reward, terminated, truncated, info
        obs, reward, terminated, truncated, info = result
        return obs, float(reward), bool(terminated or truncated), info
    obs, reward, done, info = result
    return obs, float(reward), bool(done), info


class _TFAgentsEnvAdapter:
    """Adapts a TF-Agents-style environment (reset/step return TimeSteps
    with .observation/.reward/.is_last()) to the gym-tuple protocol the core
    loop drives."""

    def __init__(self, tfagents_env):
        self._env = tfagents_env

    def reset(self):
        timestep = self._env.reset()
        return timestep.observation

    def step(self, action):
        timestep = self._env.step(action)
        reward = timestep.reward
        return (
            timestep.observation,
            float(0.0 if reward is None else np.asarray(reward)),
            bool(timestep.is_last()),
            {},
        )

    def __getattr__(self, name):
        return getattr(self._env, name)


def run_tfagents_env(tfagents_env, policy, **kwargs) -> List[float]:
    """run_env over a TF-Agents-style environment: same episode loop,
    TimeStep protocol adapted at the boundary."""
    return run_env(_TFAgentsEnvAdapter(tfagents_env), policy, **kwargs)


def run_env(
    env,
    policy,
    num_episodes: int = 1,
    max_episode_steps: Optional[int] = None,
    explore_schedule: Optional[Callable[[int], float]] = None,
    global_step: int = 0,
    episode_to_transitions_fn: Optional[Callable] = None,
    transition_to_record_fn: Optional[Callable] = None,
    replay_writer=None,
    replay_path: Optional[str] = None,
    output_dir: Optional[str] = None,
    on_episode_end: Optional[Callable[[int, List[Transition]], None]] = None,
) -> List[float]:
    """Runs episodes; returns per-episode total rewards.

    Args:
      env: gym-style environment.
      policy: a policies.Policy (sample_action interface).
      num_episodes: episodes to run.
      max_episode_steps: per-episode step cap (None = env decides).
      explore_schedule: global_step -> explore probability fed to
        policy.sample_action (None = greedy).
      global_step: the learner step these episodes are attributed to.
      episode_to_transitions_fn: [Transition] -> transitions converter
        (n-step returns, reward relabeling, Example assembly, ...).
      transition_to_record_fn: transition -> serialized bytes for the
        replay writer. With a replay_writer, supply either this OR an
        episode_to_transitions_fn whose outputs are serialized bytes.
      replay_writer: utils.writer.ReplayWriter episode sink.
      replay_path: shard path prefix passed to replay_writer.open; derived
        from `output_dir` + global_step when omitted.
      on_episode_end: callback(episode_index, transitions).
    """
    explore_prob = (
        explore_schedule(global_step) if explore_schedule is not None else 0.0
    )
    if replay_writer is not None:
        if replay_path is None and output_dir is not None:
            replay_path = writer_lib.timestamped_record_path(
                output_dir, global_step
            )
        if replay_path is None:
            raise ValueError(
                "replay_writer requires replay_path or output_dir."
            )
        if transition_to_record_fn is None and episode_to_transitions_fn is None:
            raise ValueError(
                "replay_writer requires transition_to_record_fn or an "
                "episode_to_transitions_fn producing serializable protos."
            )
        replay_writer.open(replay_path)
    episode_rewards: List[float] = []
    try:
        for episode_index in range(num_episodes):
            obs = env.reset()
            if isinstance(obs, tuple) and len(obs) == 2:  # new-gym (obs, info)
                obs = obs[0]
            if hasattr(policy, "reset"):
                policy.reset()
            episode: List[Transition] = []
            total_reward, step, done = 0.0, 0, False
            while not done:
                action, _ = policy.sample_action(obs, explore_prob)
                new_obs, reward, done, env_debug = _step_env(env, action)
                episode.append(
                    Transition(obs, action, reward, new_obs, done, env_debug)
                )
                total_reward += reward
                obs = new_obs
                step += 1
                if max_episode_steps is not None and step >= max_episode_steps:
                    break
            transitions = (
                episode_to_transitions_fn(episode)
                if episode_to_transitions_fn is not None
                else episode
            )
            if replay_writer is not None:
                if transition_to_record_fn is not None:
                    records = [transition_to_record_fn(t) for t in transitions]
                else:
                    records = transitions
                replay_writer.write(
                    writer_lib.serialize_transition_records(records)
                )
            if on_episode_end is not None:
                on_episode_end(episode_index, transitions)
            episode_rewards.append(total_reward)
            logging.info(
                "episode %d/%d: reward=%.3f steps=%d explore=%.3f",
                episode_index + 1, num_episodes, total_reward, step, explore_prob,
            )
    finally:
        if replay_writer is not None:
            replay_writer.close()
    return episode_rewards
