"""Continuous on-robot collect/eval loop.

Port of tensor2robot_tpu/utils/continuous_collect_eval.py: the
robot-process side of the async actor/learner topology. Poll-restore the
newest exported policy, run collection episodes into the replay bus, run
eval episodes, repeat until the learner passes max_steps.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional

from tensor2robot_tpu_torch.config import configurable


@configurable("collect_eval_loop")
def collect_eval_loop(
    root_dir: str,
    policy,
    run_agent_fn: Callable,
    collect_env=None,
    eval_env=None,
    num_collect: int = 10,
    num_eval: int = 5,
    min_global_step: int = 0,
    max_steps: int = 1_000_000,
    idle_sleep_secs: float = 10.0,
    init_randomly_on_timeout: bool = False,
    max_cycles: Optional[int] = None,
) -> int:
    """Runs collect+eval cycles; returns the last seen global step.

    Per cycle: restore the policy's newest weights; if the learner hasn't
    advanced (or is below min_global_step), sleep and re-poll; otherwise run
    `run_agent_fn(env, policy, num_episodes, output_dir, global_step)` on
    the collect env then the eval env. Stops once global_step >= max_steps.

    Args:
      root_dir: collect episodes land in <root_dir>/policy_collect, eval
        episodes in <root_dir>/policy_eval.
      policy: a policies.Policy.
      run_agent_fn: the episode runner (research/run_env.run_env adapted:
        fn(env, policy=, num_episodes=, output_dir=, global_step=)).
      init_randomly_on_timeout: serve random weights when no export appears
        (bring-up mode).
      max_cycles: optional cycle cap for tests.
    """
    collect_dir = os.path.join(root_dir, "policy_collect")
    eval_dir = os.path.join(root_dir, "policy_eval")
    os.makedirs(collect_dir, exist_ok=True)
    os.makedirs(eval_dir, exist_ok=True)

    last_global_step = -1
    cycles = 0
    while True:
        if not policy.restore():
            if init_randomly_on_timeout and last_global_step < 0:
                logging.warning("No exported policy yet; initializing randomly.")
                policy.init_randomly()
            else:
                logging.info("No new policy available; sleeping.")
                time.sleep(idle_sleep_secs)
                cycles += 1
                if max_cycles is not None and cycles >= max_cycles:
                    return last_global_step
                continue
        global_step = policy.global_step
        if global_step == last_global_step or global_step < min_global_step:
            time.sleep(idle_sleep_secs)
            cycles += 1
            if max_cycles is not None and cycles >= max_cycles:
                return last_global_step
            continue
        last_global_step = global_step
        if collect_env is not None:
            run_agent_fn(
                collect_env,
                policy=policy,
                num_episodes=num_collect,
                output_dir=collect_dir,
                global_step=global_step,
            )
        if eval_env is not None:
            run_agent_fn(
                eval_env,
                policy=policy,
                num_episodes=num_eval,
                output_dir=eval_dir,
                global_step=global_step,
            )
        cycles += 1
        if global_step >= max_steps:
            return global_step
        if max_cycles is not None and cycles >= max_cycles:
            return last_global_step
