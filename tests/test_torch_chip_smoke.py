"""chip_smoke.py's training, serving, critic and data phases, rehearsed on
the CPU.

The phases run here at a tiny width on the CPU (DEVICE = "cpu"), where
flash attention takes the kernels' plain versions; those are wrapped to
count as their kernels would, so the phases' launch checks (B1, B3, B4
once per layer per train step, B2 once per layer per eval or served
batch, none in the critic) are exercised as on the card. The critic runs
at 96x96 with num_convs (2, 2, 1), width 8 and batch 4; the data phase
writes 8 train records (136x264 JPEG sources, 2 shards) and 4 eval
records, checks the parsers and the codec (libjpeg here), times
RecordDataset and trains the critic from the records with 96x96 crops at
batch 4. The kernel phase needs the card and runs only there.
"""

import importlib.util
import pathlib

import pytest
import torch

from tensor2robot_tpu_torch.ops import flash_attention as fa

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "DEVICE", "cpu")
    monkeypatch.setattr(module, "card_line", lambda: "CPU rehearsal")
    monkeypatch.setattr(module, "SLICE", dict(batch=2, seq=16, heads=2, head_dim=16))
    monkeypatch.setattr(module, "NUM_LAYERS", 2)
    monkeypatch.setattr(module, "TIMED_STEPS", 2)
    monkeypatch.setattr(module, "CRITIC",
                        dict(image_size=(96, 96), num_convs=(2, 2, 1), width=8))
    monkeypatch.setattr(module, "CRITIC_BATCH", 4)
    monkeypatch.setattr(module, "BC_WIDTH", dict(image_size=(16, 16), d_model=32))
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)

    def counted(fn, *kernels):
        def run(*args, **kwargs):
            for kernel in kernels:
                fa.KERNELS[kernel].launches += 1
            return fn(*args, **kwargs)

        return run

    monkeypatch.setattr(fa, "flash_attention_plain",
                        counted(fa.flash_attention_plain, "flash_fwd"))
    monkeypatch.setattr(fa, "flash_attention_tile_plain",
                        counted(fa.flash_attention_tile_plain, "flash_fwd_tile"))
    monkeypatch.setattr(
        fa, "flash_attention_bwd_plain",
        counted(fa.flash_attention_bwd_plain, "flash_bwd_dq", "flash_bwd_dkv"),
    )
    return module


def test_training_then_serving_the_trained_checkpoint(chip_smoke, tmp_path, capsys):
    launches = chip_smoke.phase_training(str(tmp_path))
    assert launches == {
        "flash_fwd": 2 * chip_smoke.EVAL_STEPS * 2,
        "flash_fwd_tile": 2 * chip_smoke.TRAIN_STEPS,
        "flash_bwd_dq": 2 * chip_smoke.TRAIN_STEPS,
        "flash_bwd_dkv": 2 * chip_smoke.TRAIN_STEPS,
    }
    served = chip_smoke.phase_serving(str(tmp_path))
    assert served > 0 and served % 2 == 0
    out = capsys.readouterr().out
    for line in ("[training] gradient check", "[training] train_eval_model",
                 "[training] train step", "[serving] on CPU rehearsal: 24 episodes",
                 "model_version 20"):
        assert line in out, line


def test_serving_needs_the_training_phase(chip_smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py", "--phases", "serving"])
    assert chip_smoke.main() == 1
    assert '"ok"' not in capsys.readouterr().out
    monkeypatch.setattr("sys.argv", ["chip_smoke.py", "--phases", "nope"])
    assert chip_smoke.main() == 2


def test_critic_phase(chip_smoke, tmp_path, capsys):
    chip_smoke.phase_critic(str(tmp_path))
    out = capsys.readouterr().out
    for line in ("[critic] card vs CPU, batch 2 at full width",
                 "[critic] train_eval_model on CPU rehearsal: 20 steps of batch 4",
                 "EMA eval", "equal to the live one",
                 "[critic] train step (batch 4, on-device batch)"):
        assert line in out, line
    assert chip_smoke.critic_train_flops((472, 472), 64) == pytest.approx(
        1.69e12, rel=0.01)


def test_phases_list_the_critic(chip_smoke):
    assert chip_smoke.PHASES == (
        "build", "kernels", "training", "serving", "critic", "export", "policy",
        "data", "cli")


def test_policy_phase(chip_smoke, tmp_path, monkeypatch, capsys):
    """The policy phase at the critic's CPU width (seed-0 weights: no
    critic phase ran), fewer selects and a shorter pose loop. On the CPU
    JitCEMPolicy runs its loop eagerly, so the phase counts eager selects
    where the card counts graph replays."""
    monkeypatch.setattr(chip_smoke, "POLICY_SELECTS", 3)
    monkeypatch.setattr(chip_smoke, "POLICY_EAGER_SELECTS", 2)
    monkeypatch.setattr(chip_smoke, "POLICY_NUMPY_SELECTS", 1)
    monkeypatch.setattr(chip_smoke, "PREDICT_WINDOWS", 2)
    monkeypatch.setattr(chip_smoke, "PREDICT_WINDOW", 1)
    monkeypatch.setattr(chip_smoke, "POSE_COLLECT", 8)
    monkeypatch.setattr(chip_smoke, "POSE_TRAIN_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "POSE_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "POSE_EVAL", 4)
    monkeypatch.setattr(chip_smoke, "POSE_CEM_EPISODES", 2)
    chip_smoke.phase_policy(str(tmp_path))
    out = capsys.readouterr().out
    for line in ("[policy] critic (96, 96) (num_convs (2, 2, 1)) with seed 0",
                 "graph replays 3 = selects", "[policy] eager loop",
                 "re-scored through predict", "[policy] CEMPolicy (numpy engine",
                 "[policy] 64-state predict of the untiled critic export",
                 "[policy] int8 export under JitCEMPolicy: 5 selects",
                 "[policy] second version (seeded weights of a trained critic's",
                 "[policy] PoseToyEnv on CPU rehearsal: 8 random episodes",
                 "at global_step 2 (export step 2)", "2 graph replays"):
        assert line in out, line


def test_export_phase(chip_smoke, tmp_path, monkeypatch, capsys):
    """Training writes latest/best exports at steps 10 and 20 (program
    true); the export phase serves step 10 with no model code (ladder from
    the metadata), swaps to 20 under traffic, checks an int8 export and
    serves the critic's exported EMA weights against its checkpoint."""
    # At 32 wide the program's graph outweighs its weights: int8 must only
    # be smaller here (the card's full width holds it under half).
    monkeypatch.setattr(chip_smoke, "INT8_SIZE_RATIO", 1.0)
    chip_smoke.phase_training(str(tmp_path))
    assert [e["step"] for e in chip_smoke.EXPORTS if e["exporter"] == "latest"] == [10, 20]
    chip_smoke.phase_critic(str(tmp_path / "critic"))
    launches = chip_smoke.phase_export(str(tmp_path))
    assert launches > 0 and launches % 2 == 0
    out = capsys.readouterr().out
    for line in ("[training] export latest step 10", "[training] export latest step 20",
                 "[export] BC export of step 10 restored with no model code",
                 "[export] served from the export on CPU rehearsal: 24 episodes",
                 "[export] hot swap 10 -> 20 under traffic",
                 "[export] int8 export of step 20",
                 "[export] critic (EMA of step 20"):
        assert line in out, line


def test_export_needs_training_and_critic(chip_smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py", "--phases", "critic,export"])
    monkeypatch.setattr(chip_smoke, "phase_critic", lambda model_dir: None)
    assert chip_smoke.main() == 1
    assert '"ok"' not in capsys.readouterr().out


def test_data_phase(chip_smoke, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "DATA_RECORDS", (8, 2, 4))
    monkeypatch.setattr(chip_smoke, "DATA_BATCHES", 2)
    monkeypatch.setattr(chip_smoke, "PROFILED_FED_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "MEASURED", {"critic_step_ms": 12.5})
    chip_smoke.phase_data(str(tmp_path))
    out = capsys.readouterr().out
    for line in ("[build] data: JPEG codec libjpeg",
                 "[data] wrote 8 train records in 2 shards and 4 eval records "
                 "(136x264 q95 JPEG by libjpeg",
                 "FastSpecParser == SpecParser bit for bit",
                 "libjpeg q95 round trip of 8 frames",
                 "[data] libjpeg alone on CPU rehearsal:", "ROI decode (one thread",
                 "[data] thread backend, ROI on (96x96 images), batch 4",
                 "[data] thread backend, ROI off (136x264 images)",
                 "[data] process backend, ROI on", "[data] process backend, ROI off",
                 "[data] critic from records: train_eval_model on CPU rehearsal: "
                 "20 steps of batch 4", "checkpoints [10, 20]",
                 "[data] critic train step fed from records",
                 "on the card: 12.500 ms"):
        assert line in out, line


def test_cli_phase(chip_smoke, tmp_path, capsys, monkeypatch):
    """The binaries as child processes at a tiny width on the CPU: the BC
    learner (remat, grad-accum 2, 5 steps a loop, six hook builders)
    beside the continuous-eval job, the regimes in process (launches per
    step, the gradient gate, iterations_per_loop 5 vs 1), and the shipped
    pose_env configs (12 episodes, 2 steps of batch 4) and the
    reward-bearing bf16 step of run_train_reg.gin's model."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(chip_smoke, "CLI_POSE",
                        dict(collect=12, steps=2, eval_steps=1, batch=4))
    launches = chip_smoke.phase_cli(str(tmp_path))
    layers = 2
    steps = chip_smoke.CLI_IPL_STEPS * 2
    assert launches == {"flash_fwd": 0, "flash_fwd_tile": 4 * layers + steps * layers,
                        "flash_bwd_dq": 2 * layers + steps * layers,
                        "flash_bwd_dkv": 2 * layers + steps * layers}
    out = capsys.readouterr().out
    for line in ("[cli] remat + grad_accum_steps 2 vs plain on CPU rehearsal",
                 "[cli] 10 steps at iterations_per_loop 5 vs 1 (deterministic cuDNN convs): "
                 "parameters bit-equal",
                 "[cli] trainer binary on CPU rehearsal: 20 steps",
                 "[cli] continuous-eval binary: steps [10, 20]",
                 "[cli] steps/s of remat + grad_accum_steps 2 on CPU rehearsal",
                 "[cli] pose_env configs on CPU rehearsal: run_random_collect.gin 12",
                 "[cli] run_train_reg.gin's model, a reward-bearing bf16 step vs f32 on "
                 "CPU rehearsal: loss"):
        assert line in out, out
