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
batch 4. The stream phase streams a 16-step episode (windows 3 and None,
and 4 experts) and the moe phase trains 4 experts at the same tiny BC
width. The kernel phase needs the card and runs only there.
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
        "build", "kernels", "training", "serving", "critic", "export", "serve_quant",
        "policy", "data", "cli", "meta", "stream", "moe", "grasp2vec", "vrgripper",
        "maml_export", "stem_s2d", "png", "parallel")


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


def test_serve_quant_needs_training_and_critic(chip_smoke, monkeypatch, capsys):
    """The serve_quant phase exports the training and critic phases'
    weights: asked for without them, the run fails with no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py", "--phases", "critic,serve_quant"])
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


def test_meta_phase(chip_smoke, tmp_path, capsys, monkeypatch):
    """The meta phase on the CPU at the model's widths with 2 tasks a
    batch: card-vs-CPU (here CPU against CPU) for both orders, the shipped
    run_train_reg_maml.gin through the binaries for 2 steps, and 4 tasks of
    meta-example records, 2 steps from them and run_meta_env over 2
    tasks."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(chip_smoke, "META_TASKS", 2)
    monkeypatch.setattr(chip_smoke, "META_TIMED_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "META_CLI", dict(steps=2, eval_steps=1))
    monkeypatch.setattr(chip_smoke, "META_RECORD_TASKS", 4)
    monkeypatch.setattr(chip_smoke, "META_RECORD_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "META_ENV", dict(tasks=2, adaptations=2))
    chip_smoke.phase_meta(str(tmp_path))
    out = capsys.readouterr().out
    for line in ("[meta] card vs CPU, 2 tasks x (3 condition + 3 inference) at 64x64",
                 "second order loss", "first order loss",
                 "[meta] synced outer step (on-device batch, median of 2) on CPU rehearsal",
                 "[meta] run_train_reg_maml.gin through the binaries on CPU rehearsal",
                 "continuous eval steps [2]",
                 "[meta] records to a policy on CPU rehearsal: 4 meta-example records",
                 "step_1_improvement", "policy vs direct forward"):
        assert line in out, out
    assert set(chip_smoke.MEASURED["meta_timed"]) == {"second order", "first order"}


def test_stream_phase(chip_smoke, tmp_path, capsys, monkeypatch):
    """The stream phase at the tiny BC width: each window's 16-step episode
    against the full forward, the eager route (the CPU's only one, so it
    counts eager steps where the card counts graph replays), the streaming
    export restored with no model code, and 4 experts."""
    monkeypatch.setattr(chip_smoke, "STREAM_ATTENTION_WINDOWS", (3, None))
    monkeypatch.setattr(chip_smoke, "STREAM_WINDOWS", 2)
    monkeypatch.setattr(chip_smoke, "STREAM_WINDOW", 4)
    monkeypatch.setattr(chip_smoke, "STREAM_EAGER_STEPS", 4)
    chip_smoke.phase_stream(str(tmp_path))
    out = capsys.readouterr().out
    for line in ("[stream] window 3 on CPU rehearsal: 16 steps at batch 1 within 0.0001",
                 "eager steps 25 = steps; no flash launch",
                 "[stream] window 3 eager (no graph)", "[stream] window 3 export: written",
                 "16 steps within 1e-05 of the in-process policy",
                 "[stream] window None on CPU rehearsal", "[stream] window None export",
                 "[stream] window 3, 4 experts on CPU rehearsal"):
        assert line in out, out
    assert "[stream] window 3, 4 experts export" not in out


def test_moe_phase(chip_smoke, tmp_path, capsys):
    """The moe phase at the tiny BC width with 4 experts: the gradient
    gate through the (counted) plain kernels with routing flips counted,
    B1/B3/B4 once per layer per step, and no aux outside the train
    outputs."""
    launches = chip_smoke.phase_moe(str(tmp_path))
    layers, steps = 2, 2 + chip_smoke.TIMED_STEPS + 3
    assert launches == {"flash_fwd": 2 * layers, "flash_fwd_tile": layers * (1 + steps),
                        "flash_bwd_dq": layers * (1 + steps),
                        "flash_bwd_dkv": layers * (1 + steps)}
    out = capsys.readouterr().out
    for line in ("[moe] 4 experts (k = 2) gradient check on CPU rehearsal: loss",
                 "routing picks differing 0 over 2 episodes (episodes left out: none)",
                 "[moe] train step (batch 2, 4 experts, on-device batch) on CPU rehearsal",
                 "the dense step not measured in this run",
                 "[moe] loss/moe_aux", "carry no aux"):
        assert line in out, out


def test_moe_flips_leave_their_episode_out(chip_smoke, monkeypatch, capsys):
    """A pick that differs between the two paths under the margin takes its
    episode out of the comparison; past the margin it fails the phase."""
    picks = iter([])

    def fake_backward(trainer, network, batch):
        loss, metrics, real = real_backward(trainer, network, batch)
        return loss, metrics, next(picks)(real)

    real_backward = chip_smoke._moe_backward
    monkeypatch.setattr(chip_smoke, "_moe_backward", fake_backward)

    def flipped(margin):
        def edit(real):
            ids, m = real[0]
            ids = ids.clone()
            ids[0, 3] = ids[0, 3].flip(0)
            m = m.clone()
            m[0, 3] = margin
            return [(ids, m)] + real[1:]
        return edit

    same = lambda real: real  # noqa: E731
    picks = iter([flipped(1e-7), same, same, same])
    chip_smoke.moe_gradient_check()
    out = capsys.readouterr().out
    assert "episodes [0] left out of the comparison" in out
    assert "over 1 episodes (episodes left out: [0])" in out
    picks = iter([flipped(1e-3), same])
    with pytest.raises(AssertionError, match="routing differs past the margin"):
        chip_smoke.moe_gradient_check()


def test_grasp2vec_phase(chip_smoke, tmp_path, capsys, monkeypatch):
    """The grasp2vec phase at ResNet-18 and 32x32 crops (of 512x640 JPEG
    sources): card vs CPU (here CPU against CPU), 20 steps from 8 records,
    the step's cost, the served embeddings and a triplet step; and the
    full-width step's flop count."""
    monkeypatch.setattr(chip_smoke, "G2V_MODEL",
                        dict(scene_size=(32, 32), goal_size=(32, 32), resnet_size=18))
    monkeypatch.setattr(chip_smoke, "G2V_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "G2V_RECORDS", (4, 2, 2))
    chip_smoke.phase_grasp2vec(str(tmp_path))
    out = capsys.readouterr().out
    for line in ("[grasp2vec] card vs CPU, batch 2 at full width", "gradients vs float64",
                 "[grasp2vec] train_eval_model on CPU rehearsal: 20 steps of batch 2",
                 "[grasp2vec] train step (batch 2, on-device batch",
                 "[grasp2vec] CheckpointPredictor at step 20: 6 outputs",
                 "[grasp2vec] one triplet_embedding_loss step from step 20"):
        assert line in out, out
    # ResNet-50 at 472x472: ~36 GFLOP a forward per image (the conv count
    # of the 224x224 network's 4.1 GMACs, scaled by (472 / 224)^2).
    assert chip_smoke.resnet_conv_flops((224, 224)) == pytest.approx(8.2e9, rel=0.02)
    assert chip_smoke.grasp2vec_train_flops((472, 472), (472, 472), 8) == pytest.approx(
        2.6e12, rel=0.05)


def test_vrgripper_phase(chip_smoke, tmp_path, capsys, monkeypatch):
    """The vrgripper phase at its widths with 2 episodes (2 tasks) a batch
    and 2 steps: card vs CPU (here CPU against CPU) and the steps of each
    family, then the MSE model's trainer run and its served actions."""
    monkeypatch.setattr(chip_smoke, "VRG_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "VRG_TASKS", 2)
    monkeypatch.setattr(chip_smoke, "VRG_STEPS", 2)
    chip_smoke.phase_vrgripper(str(tmp_path))
    out = capsys.readouterr().out
    for name in ("regression_mse", "regression_mdn3", "domain_adaptive", "tec",
                 "wtl_trial", "maml_second_order"):
        assert f"[vrgripper] {name} (2 " in out, out
    for line in ("card vs CPU loss", "[vrgripper] regression_mse train_eval_model on CPU "
                 "rehearsal: 2 steps of batch 2", "CheckpointPredictor at step 2"):
        assert line in out, out


def test_maml_export_phase(chip_smoke, tmp_path, capsys, monkeypatch):
    """The maml_export phase at the models' widths with 2 tasks: the pose
    MAML model's programs at batches 1 and 2, VRGripper's at 2 and the
    policy model's at 1, each held to its checkpoint forward; then a MAML
    policy episode from the export."""
    monkeypatch.setattr(chip_smoke, "META_TASKS", 2)
    monkeypatch.setattr(chip_smoke, "MAML_EXPORT_BATCHES", (1, 2))
    monkeypatch.setattr(chip_smoke, "VRG_TASKS", 2)
    monkeypatch.setattr(chip_smoke, "MAML_TIMED_PREDICTS", 1)
    chip_smoke.phase_maml_export(str(tmp_path))
    out = capsys.readouterr().out
    for line in ("[maml_export] pose MAML (run_train_reg_maml.gin model, 3 + 3 samples at "
                 "64x64) on CPU rehearsal: programs at batches [1, 2]",
                 "[maml_export] VRGripper MAML (JAX defaults) on CPU rehearsal: programs at "
                 "batches [2]",
                 "[maml_export] pose MAML policy model (1 + 1 samples)",
                 "[maml_export] MAML policy from the export on CPU rehearsal",
                 "action vs the checkpoint policy's"):
        assert line in out, out


def test_stem_s2d_phase(chip_smoke, tmp_path, capsys, monkeypatch):
    """The stem_s2d phase at the rehearsal critic (96x96, (2, 2, 1), width
    8, batch 4): S2D vs plain stem, S2D steps, and PCGrad card vs CPU (here
    CPU against CPU, pinned)."""
    monkeypatch.setattr(chip_smoke, "S2D_STEPS", 2)
    chip_smoke.phase_stem_s2d(str(tmp_path))
    out = capsys.readouterr().out
    for line in ("[stem_s2d] critic (batch 4, 96x96, f32, TF32 off) on CPU rehearsal: "
                 "S2D stem vs plain", "eval logits", "synced step plain",
                 "[stem_s2d] PCGrad step (critic loss split into 2 tasks of 2",
                 "combined gradients worst"):
        assert line in out, out


def test_png_phase(chip_smoke, tmp_path, capsys, monkeypatch):
    """The png phase on the rehearsal critic's 136x264 sources: 8 + 4 PNG
    records, parsed back exactly, decode rates, 2 steps fed from them."""
    monkeypatch.setattr(chip_smoke, "PNG_RECORDS", (8, 2, 4))
    monkeypatch.setattr(chip_smoke, "PNG_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "PNG_BATCHES", 2)
    chip_smoke.phase_png(str(tmp_path))
    out = capsys.readouterr().out
    for line in ("[png] 12 records of 136x264 RGB PNG sources", "parsed back bit for bit",
                 "PNG ", "MB/s", "JPEG ", "2 critic steps fed from PNG records on CPU "
                 "rehearsal"):
        assert line in out, out


def test_parallel_phase(chip_smoke, tmp_path, capsys, monkeypatch):
    """The parallel phase on 4 gloo ranks on the CPU at the rehearsal BC
    width (T = 16, 4 frames a rank; 4 heads of 8 so Ulysses splits them;
    a window of 6 truncates the ring to 3 of its 4 hops), then its
    sub-phases: the critic at 96x96 (num_convs (2, 2, 1), batch 8) on 2
    data x 2 fsdp ranks, its train_eval_model run from 16 + 8 records,
    MoE BC at the same rehearsal width on 2 data x 2 expert ranks, and BC
    pipelined over 2 data x 2 pipe ranks (1 block a stage, 1 microbatch),
    its ring-in-pipe step on 2 sequence x 2 pipe, its trainer run with a
    stacked checkpoint and a resume, BC's ZeRO-2 regimes on a 4-rank
    data mesh (global batch 8, 2 steps of each codec after a replicated
    step, the int8 trainer run with its residuals in the checkpoint and a
    resume, and the flat update on one device), and BC's parameters
    sharded over 1 data x 2 fsdp x 2 model ranks (d_model 128 here, so
    that leaves reach mesh.MIN_WEIGHT_SIZE; global batch 2: the checked
    step, its control, bytes a rank, 2 + 2 timed steps and as many with
    every sharded leaf gathered on use, then a clipped
    trainer run of 2 steps resumed on one device and served), BC's
    composed regimes on the same ranks (d_model 128, global batch 4: six
    meshes' checked steps and 2 + 2 timed steps but the flat update's,
    three controls, a clipped trainer run of 2 steps on 2 data x 2
    sequence resumed in sharded_params on 2 fsdp x 2 sequence and on one
    device, and served), MoE BC on 2 expert x 2 sequence ranks (its
    checked step, its eval, the control, 2 + 2 timed steps), pose MAML of
    4 tasks on 1 data x 2 fsdp x 2 model ranks (second and first order,
    each with 2 + 1 timed steps; no flash kernel), the planner (dp_pp_zero2
    built by its plan against the hand-wired trainer, global batch 8, one
    gate step each; a cold T2R_PLAN=auto search measuring shortlist-2 with
    1 timed step, a warm one from the cache, the winner's step), and
    dp_sp_pp on 8 more
    ranks (its step, its twin's, 2 + 1 timed steps). The ranks import
    chip_smoke afresh and take their sizes and device from the phase's
    spec, and count the plain versions' calls as launches themselves."""
    import sys

    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    monkeypatch.setattr(chip_smoke, "PARALLEL_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SLICE", dict(batch=2, seq=16, heads=4, head_dim=8))
    monkeypatch.setattr(chip_smoke, "PARALLEL_TIMED_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "PARALLEL_REGIMES", {
        "ring": ("ring", None, 2 * 4), "ulysses": ("ulysses", None, 2),
        "ring_window6": ("ring", 6, 2 * 3)})
    monkeypatch.setattr(chip_smoke, "PARALLEL_CRITIC", dict(
        model=dict(image_size=(96, 96), num_convs=(2, 2, 1)), batch=8, mesh=(2, 2),
        timed=2, steps=2, records=(16, 4, 8)))
    monkeypatch.setattr(chip_smoke, "PARALLEL_MOE", dict(experts=4, mesh=(2, 2), timed=2))
    monkeypatch.setattr(chip_smoke, "PARALLEL_ZERO2", dict(chip_smoke.PARALLEL_ZERO2, steps=2))
    # d_model 128: the sharded sub-phase's kernels, embed and second conv
    # reach mesh.MIN_WEIGHT_SIZE and shard (at d_model 32 nothing would).
    monkeypatch.setattr(chip_smoke, "BC_WIDTH", dict(image_size=(16, 16), d_model=128))
    monkeypatch.setattr(chip_smoke, "PARALLEL_SHARDED", dict(
        chip_smoke.PARALLEL_SHARDED, batch=2, train=dict(steps=2, save_every=2,
                                                         eval_steps=1)))
    monkeypatch.setattr(chip_smoke, "PARALLEL_COMPOSED", dict(
        chip_smoke.PARALLEL_COMPOSED, batch=4, train=dict(steps=2, save_every=2,
                                                          eval_steps=1)))
    monkeypatch.setattr(chip_smoke, "PARALLEL_3D", dict(chip_smoke.PARALLEL_3D, batch=4,
                                                        timed=1))
    monkeypatch.setattr(chip_smoke, "PARALLEL_MOE_SEQUENCE",
                        dict(chip_smoke.PARALLEL_MOE_SEQUENCE, timed=2))
    monkeypatch.setattr(chip_smoke, "PARALLEL_MAML", dict(chip_smoke.PARALLEL_MAML, tasks=4,
                                                          timed=1))
    launches = chip_smoke.phase_parallel(str(tmp_path))
    # Per rank: the checked step, the eval forward, 2 + 2 timed steps and
    # 2 more steps; the 2 x 2 run's 4 steps and 2 evals of 2 hops x 2
    # layers; the served batch's B2 in this process; MoE's checked step
    # and 2 + 2 timed steps, 2 layers each; and the pipe's checked step,
    # its eval (B2), 2 + 2 timed steps and 2 more, then two trainer runs
    # of 2 steps and an eval each, 1 block x 1 microbatch a rank each
    # time, and its served batch's B2 (2 layers) in this process.
    # ZeRO-2: per rank the replicated step and 5 codecs x 2 steps, two
    # trainer runs of 2 steps and an eval each, 2 layers each time; the
    # served batch's B2 and the two one-device flat-check steps in this
    # process. Sharded params: per rank the checked step and 2 + 2 timed
    # steps (the control's step and the 2 + 2 steps gathered on use are
    # not counted), its eval's B2, and the
    # trainer run of 2 steps with one eval, 2 layers each time; the served
    # batch's B2 in this process. Composed: per rank the checked step
    # and 2 + 2 timed steps of the three sequence meshes (2 layers x 2
    # hops) and of the two timed pipe meshes (1 block x 2 microbatches),
    # the flat update's checked step, and the trainer run's 2 steps and
    # one ring eval; the served batch's B2 in this process. MoE x sequence:
    # per rank the checked step, its eval's B1 and 2 + 2 timed steps, 2
    # layers x 2 hops each time. The planner: per rank the preset's two
    # gate steps (1 block x 4 microbatches), the probe's 1 + 1 steps and
    # the winner's step on 4 data ranks (2 layers each). Sharded MAML and
    # dp_sp_pp none.
    steps = 1 + 4 + 2
    moe = 4 * (1 + 4) * 2
    pipe = 4 * (1 + 4 + 2 + 2 * 2)
    zero2 = 4 * (1 + 5 * 2 + 2 * 2) * 2 + 2 * 2
    sharded = 4 * (1 + 4 + 2) * 2
    composed = 4 * (3 * 4 * (1 + 4) + 2 * 2 * (1 + 4) + 2 * 1)
    moe_sequence = 4 * 4 * (1 + 4)
    plan = 4 * (2 * 4 + 2 * 2 + 2)
    assert launches == {
        "flash_fwd": 4 * 2 + 2 + 4 * (1 + 2) + 2 + 4 * 2 * 2 + 2 + 4 * (2 + 2) + 2 + 2,
        "flash_fwd_tile": (4 * ((steps + 1) * 8 + steps * 2 + (steps + 1) * 6 + 4 * 6)
                           + moe + pipe + zero2 + sharded + composed + 4 * 4 * (2 + 1)
                           + moe_sequence + 4 * 4 + plan),
        "flash_bwd_dq": (4 * (steps * (8 + 2 + 6) + 4 * 4) + moe + pipe + zero2 + sharded
                         + composed + 4 * 4 * 2 + moe_sequence + plan),
        "flash_bwd_dkv": (4 * (steps * (8 + 2 + 6) + 4 * 4) + moe + pipe + zero2 + sharded
                          + composed + 4 * 4 * 2 + moe_sequence + plan),
    }
    out = capsys.readouterr().out
    for line in ("[parallel] 4 gloo ranks on cpu up in", "[parallel] ring (sequence 4",
                 "[parallel] ulysses (sequence 4", "[parallel] ring_window6 (sequence 4",
                 "worst gradient", "gloo host-staged 0.000 MB a step",
                 "[parallel] train_eval_model on a 2 x 2 data x sequence mesh",
                 "4.pt served on one card by CheckpointPredictor",
                 "[parallel_critic] full-width f32 critic (96, 96), batch 8 on a 2 data x 2",
                 "control with per-shard moments", "(fails, as it must)",
                 "[parallel_critic] train_eval_model on the mesh",
                 "StepTimingHook on rank 0 only (1 rows",
                 "[parallel_moe] MoE BC (4 experts, k = 2, 2 resident a rank)",
                 "B1/B3/B4 2 each a rank a step", "[parallel_moe] sub-phase",
                 "[parallel_pipe] BC pipelined over 2 stages (1 blocks a stage, 1 "
                 "microbatches", "B1/B3/B4 1 each a rank a step (B2 1 in its eval)",
                 "[parallel_pipe] ring in pipe: one step on a 2 sequence x 2 pipe mesh",
                 "no kernel launch", "[parallel_pipe] train_eval_model on the 2 x 2",
                 "2.pt holds the stages stacked ((2, ", "4.pt served on one card by "
                 "CheckpointPredictor", "[parallel_pipe] sub-phase",
                 "[parallel_zero2] BC (", "on a 4-rank data mesh, global batch 8, block 512",
                 "[parallel_zero2] none (zero2)", "step 1 vs the replicated step",
                 "[parallel_zero2] int8 (quant_zero2)", "(3.97x)",
                 "[parallel_zero2] fp8_e5m2 (quant_zero2)", "after 2 steps vs the exact run",
                 "[parallel_zero2] train_eval_model in int8", "2.pt holds the residuals ((4, ",
                 "[parallel_zero2] flatten_optimizer_update on one card",
                 "[parallel_zero2] sub-phase",
                 "[parallel_critic] full-width f32 critic", "regime sharded_params: ",
                 "leaves sharded over fsdp, parameters",
                 "[parallel_sharded] BC (", "on a 1 data x 2 fsdp x 2 model mesh, global "
                 "batch 2 (1 episodes a data x fsdp shard), regime sharded_params",
                 "parameters split 4 ways", "one step vs the single-device step",
                 "(fails, as it must)", "B1/B3/B4 2 each a rank a step (B2 2 in its eval)",
                 "every sharded leaf gathered on use (no column split), same ranks and "
                 "batch: synced step median",
                 "[parallel_sharded] train_eval_model on the 1 x 2 x 2 mesh clipped to "
                 "global norm 0.05", "the same on every rank",
                 "2.pt resumed on one card equal bit for bit to the mesh's resume",
                 "2.pt served on one card by CheckpointPredictor",
                 "[parallel_sharded] sub-phase",
                 "[parallel_composed] (a) zero2 on data x fsdp x sequence x pipe 2x1x2x1",
                 "[parallel_composed] (b) zero2", "[parallel_composed] (c) zero2",
                 "[parallel_composed] (d) sharded_params", "[parallel_composed] (e) "
                 "sharded_params", "[parallel_composed] (f) replicated",
                 "gate only", "B1/B3/B4 4 each a rank a step", "B1/B3/B4 2 each a rank a step",
                 "[parallel_composed] control (a) slice_over_data (must fail)",
                 "[parallel_composed] control (d) whole_over_data_fsdp (must fail)",
                 "[parallel_composed] control (c) stages_unaveraged (must fail)",
                 "[parallel_composed] train_eval_model on mesh (a) clipped to global norm",
                 "2.pt resumed in sharded_params on mesh (d)",
                 "[parallel_composed] sub-phase",
                 "[parallel_moe_sequence] MoE BC (4 experts, k = 2, 2 resident a rank) on "
                 "a 2 expert x 2 sequence (ring) mesh", "(left out: none)",
                 "B1/B3/B4 4 each a rank a step (B1 4 in its eval)",
                 "[parallel_moe_sequence] sub-phase",
                 "[parallel_maml_sharded] pose MAML second order, 4 tasks x (3 + 3), f32, on "
                 "a 1 data x 2 fsdp x 2 model mesh, leaves of 8192 elements or more sharded "
                 "(5: ", "control (an fsdp-cut leaf's gradient not reduced over fsdp)",
                 "[parallel_maml_sharded] pose MAML first order",
                 "[parallel_maml_sharded] sub-phase",
                 "[parallel_plan] (a) preset dp_pp_zero2 on CPU rehearsal", "audit clean over ",
                 "every parameter and optimizer state tensor bit for bit on every rank; "
                 "B1/B3/B4 4 each a rank a step, the hand-wired step's",
                 "[parallel_plan] (b) analytic table: dp4_sp1_pp1 memory",
                 "[parallel_plan] (b) probe dp4_sp1_pp1 on CPU rehearsal: step",
                 " skipped: the trainer's mesh shards the sequence 2-way but the model's",
                 "cold measured with 1 probe(s)", "warm cache with 0 probes",
                 "to_json() byte-identical on every rank", "[parallel_plan] sub-phase",
                 "[parallel_3d] dp_sp_pp: 8 gloo ranks on cpu up in",
                 "no flash launch", "[parallel_3d] sub-phase"):
        assert line in out, out
