"""The port's three binaries as real OS processes on the CPU: the
counterpart of tests/test_cli.py at its sizes (collect 12 episodes, 2
train steps of batch 4, one eval batch). Each runs as `python -m
tensor2robot_tpu_torch.bin.<name>` in a fresh interpreter with the JAX
binaries' flags, on the JAX package's shipped pose_env configs, exchanging
data only through the filesystem. The trainer's child runs with JAX and
the JAX package blocked in sys.modules, so an import of either fails it.
"""

import glob
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "tensor2robot_tpu", "research", "pose_env", "configs")
# Runs a module as __main__ with JAX and the JAX package blocked.
_BLOCKED = """
import runpy, sys
for name in ("jax", "jaxlib", "flax", "tensor2robot_tpu"):
    sys.modules[name] = None
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _run_cli(module, args, blocked=False, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    command = ([sys.executable, "-c", _BLOCKED, module] if blocked
               else [sys.executable, "-m", module])
    proc = subprocess.run(command + list(args), capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT, env=env)
    assert proc.returncode == 0, (
        f"{module} failed rc={proc.returncode}\n"
        f"stdout: {proc.stdout[-2000:]}\nstderr: {proc.stderr[-3000:]}")
    return proc


def test_collect_then_train_then_eval_clis(tmp_path):
    collect_dir = tmp_path / "collect"
    _run_cli("tensor2robot_tpu_torch.bin.run_collect_eval", [
        f"--root_dir={collect_dir}",
        f"--gin_configs={os.path.join(CONFIGS, 'run_random_collect.gin')}",
        "--gin_bindings=collect_eval_loop.num_collect = 12",
    ])
    shards = glob.glob(str(collect_dir / "policy_collect" / "*.tfrecord"))
    assert shards, f"collect CLI wrote no shards under {collect_dir}"

    run_dir = tmp_path / "run"
    trainer = _run_cli("tensor2robot_tpu_torch.bin.run_t2r_trainer", [
        f"--gin_configs={os.path.join(CONFIGS, 'run_train_reg.gin')}",
        f"--gin_bindings=TRAIN_DATA = {shards!r}",
        f"--gin_bindings=EVAL_DATA = {shards!r}",
        "--gin_bindings=train_eval_model.max_train_steps = 2",
        "--gin_bindings=train_eval_model.eval_steps = 1",
        "--gin_bindings=train_input_generator/DefaultRecordInputGenerator.batch_size = 4",
        "--gin_bindings=eval_input_generator/DefaultRecordInputGenerator.batch_size = 4",
        f"--gin_bindings=train_eval_model.model_dir = {str(run_dir)!r}",
        "--gin_bindings=train_eval_model.device = 'cpu'",
    ], blocked=True)
    # device_type 'tpu' from the config: the bf16 wrapper's specs.
    assert "dtype=torch.bfloat16" in trainer.stdout
    assert sorted(os.listdir(run_dir / "checkpoints")) == ["2.durable.json", "2.pt"]
    operative = (run_dir / "operative_config.gin").read_text()
    assert "import tensor2robot_tpu_torch.config.defaults" in operative
    assert "PoseEnvRegressionModel.device_type = 'tpu'" in operative

    _run_cli("tensor2robot_tpu_torch.bin.run_continuous_eval", [
        f"--gin_configs={os.path.join(CONFIGS, 'run_train_reg.gin')}",
        f"--gin_bindings=EVAL_DATA = {shards!r}",
        "--gin_bindings=eval_input_generator/DefaultRecordInputGenerator.batch_size = 4",
        "--gin_bindings=continuous_eval.t2r_model = @PoseEnvRegressionModel()",
        "--gin_bindings=continuous_eval.input_generator_eval = {'cli': %EVAL_INPUT_GENERATOR}",
        f"--gin_bindings=continuous_eval.model_dir = {str(run_dir)!r}",
        "--gin_bindings=continuous_eval.eval_steps = 1",
        "--gin_bindings=continuous_eval.max_train_steps = 2",
        "--gin_bindings=continuous_eval.timeout = 60.0",
        "--gin_bindings=continuous_eval.device = 'cpu'",
    ])
    rows = (run_dir / "eval_cli" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 1 and '"step": 2' in rows[0]
    assert os.path.isdir(run_dir / "current_eval_checkpoint" / "checkpoints")


def test_flags_are_the_jax_binaries(tmp_path):
    """--gin_configs and --gin_bindings repeat and apply in order; the
    binary without a card and without a device binding raises."""
    from tensor2robot_tpu_torch.bin import cli

    args = cli.parse_flags("x", ["--gin_configs=a.gin", "--gin_configs", "b.gin",
                                 "--gin_bindings=x.y = 1", "--gin_bindings=x.z = 2"])
    assert args.gin_configs == ["a.gin", "b.gin"]
    assert args.gin_bindings == ["x.y = 1", "x.z = 2"]
    args = cli.parse_flags("x", ["--root_dir=/r"], root_dir=True)
    assert args.root_dir == "/r" and args.gin_configs == []
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "tensor2robot_tpu_torch.bin.run_t2r_trainer",
         "--gin_bindings=train_eval_model.t2r_model = @MockT2RModel()",
         "--gin_bindings=train_eval_model.input_generator_train = @MockInputGenerator()",
         f"--gin_bindings=train_eval_model.model_dir = {str(tmp_path)!r}"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
