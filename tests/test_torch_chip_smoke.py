"""chip_smoke.py's training and serving phases, rehearsed on the CPU.

The phases run here at a tiny width on the CPU (DEVICE = "cpu"), where
flash attention takes the kernels' plain versions; those are wrapped to
count as their kernels would, so the phases' launch checks (B1, B3, B4
once per layer per train step, B2 once per layer per eval or served
batch) are exercised as on the card. The kernel phase needs the card and
runs only there.
"""

import importlib.util
import pathlib

import pytest
import torch

from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
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
    monkeypatch.setattr(
        module, "full_width_model",
        lambda use_flash: TransformerBCModel(
            episode_length=16, image_size=(16, 16), d_model=32, num_layers=2,
            num_heads=2, head_dim=16, use_flash=use_flash,
        ),
    )
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
