"""The port stands alone: no JAX, no JAX package, no protobuf or PIL, no
absl or gin, no library attention, no native library of the JAX package,
and the card by default.

The import check runs in a SUBPROCESS: blocking jax in this process would
break every JAX test that later shares the pytest worker.
"""

import ast
import inspect
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "tensor2robot_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensor2robot_tpu",
             "google", "PIL", "absl", "gin")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention_or_compile(path):
    """chip_smoke.py times SDPA as a yardstick; nothing in the package
    may call it, nor torch.compile."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        sdpa = node.attr == "scaled_dot_product_attention"
        compile_call = (
            node.attr == "compile"
            and isinstance(node.value, ast.Name)
            and node.value.id == "torch"
        )
        if compile_call or (sdpa and path.name != "chip_smoke.py"):
            pytest.fail(f"{path}:{node.lineno} uses .{node.attr}")


@pytest.mark.parametrize(
    "path", SOURCES + sorted((PACKAGE / "data" / "csrc").glob("*.cc")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_native_library_of_the_jax_package(path):
    """The port builds its own native sources (data/csrc) into build/: no
    file names the JAX package's native directory or its libraries."""
    text = path.read_text()
    for name in ("tensor2robot_tpu/native", "libt2r_io", "libt2r_jpeg"):
        assert name not in text, f"{path} names {name}"


def test_imports_with_jax_blocked_in_a_subprocess():
    modules = list(_modules())
    script = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"for module in {modules!r}:\n"
        "    __import__(module)\n"
        "import tensor2robot_tpu_torch.ops.flash_attention as fa\n"
        "import torch\n"
        "q = torch.zeros(1, 4, 1, 32)\n"
        "assert fa.flash_attention(q, q, q, causal=True).shape == q.shape\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    result = subprocess.run(
        [sys.executable, "-c", script], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert result.returncode == 0, result.stderr[-3000:]
    assert "imported" in result.stdout


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    from tensor2robot_tpu_torch.models.abstract_model import TorchT2RModel
    from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
    from tensor2robot_tpu_torch.predictors import CheckpointPredictor
    from tensor2robot_tpu_torch.utils import device

    assert device.DEFAULT_DEVICE == "cuda"
    for fn in (CheckpointPredictor.__init__, TorchT2RModel.init_network):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = TransformerBCModel(episode_length=8, image_size=(8, 8))
    with pytest.raises(RuntimeError, match="is_available"):
        CheckpointPredictor(model)
    with pytest.raises(RuntimeError, match="is_available"):
        model.init_network()
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_alone_fails_without_a_result(tmp_path):
    """In a directory holding only chip_smoke.py (and here, with no card)
    the script exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    result = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert result.returncode != 0
    assert '"ok"' not in result.stdout


@pytest.mark.parametrize("module", [
    "tensor2robot_tpu_torch.config.registry",
    "tensor2robot_tpu_torch.ops.cem",
    "tensor2robot_tpu_torch.policies.policies",
    "tensor2robot_tpu_torch.utils.cross_entropy",
    "tensor2robot_tpu_torch.utils.writer",
    "tensor2robot_tpu_torch.utils.image",
    "tensor2robot_tpu_torch.utils.continuous_collect_eval",
    "tensor2robot_tpu_torch.research.run_env",
    "tensor2robot_tpu_torch.research.pose_env.pose_env",
    "tensor2robot_tpu_torch.research.pose_env.episode_to_transitions",
    "tensor2robot_tpu_torch.research.pose_env.pose_env_models",
    "tensor2robot_tpu_torch.research.dql_grasping_lib.tf_modules",
    "tensor2robot_tpu_torch.layers.vision_layers",
])
def test_the_subprocess_import_covers_the_policy_slice(module):
    """Every module of the policy slice is among those the blocked-jax
    subprocess imports and the import scans parse."""
    assert module in set(_modules())
    path = ROOT / (module.replace(".", "/") + ".py")
    assert path in SOURCES


@pytest.mark.parametrize("module", [
    "tensor2robot_tpu_torch.bin.cli",
    "tensor2robot_tpu_torch.bin.run_t2r_trainer",
    "tensor2robot_tpu_torch.bin.run_continuous_eval",
    "tensor2robot_tpu_torch.bin.run_collect_eval",
    "tensor2robot_tpu_torch.config.defaults",
    "tensor2robot_tpu_torch.hooks.async_export_hook_builder",
    "tensor2robot_tpu_torch.hooks.checkpoint_hooks",
    "tensor2robot_tpu_torch.hooks.gin_config_hook_builder",
    "tensor2robot_tpu_torch.hooks.golden_values_hook_builder",
    "tensor2robot_tpu_torch.hooks.hook_builder",
    "tensor2robot_tpu_torch.hooks.profiling_hook_builder",
    "tensor2robot_tpu_torch.hooks.td3",
    "tensor2robot_tpu_torch.hooks.variable_logger_hook",
    "tensor2robot_tpu_torch.layers.remat",
    "tensor2robot_tpu_torch.models.checkpoint_init",
    "tensor2robot_tpu_torch.train.continuous_eval",
    "tensor2robot_tpu_torch.train.durability",
    "tensor2robot_tpu_torch.utils.mocks",
])
def test_the_subprocess_import_covers_the_cli_slice(module):
    """Every module of the trainer's command-line slice is among those the
    blocked-jax subprocess imports and the import scans parse."""
    assert module in set(_modules())
    path = ROOT / (module.replace(".", "/") + ".py")
    assert path in SOURCES


@pytest.mark.parametrize("module", [
    "tensor2robot_tpu_torch.meta_learning",
    "tensor2robot_tpu_torch.meta_learning.meta_tfdata",
    "tensor2robot_tpu_torch.meta_learning.preprocessors",
    "tensor2robot_tpu_torch.meta_learning.maml_inner_loop",
    "tensor2robot_tpu_torch.meta_learning.maml_model",
    "tensor2robot_tpu_torch.meta_learning.meta_example",
    "tensor2robot_tpu_torch.meta_learning.meta_policies",
    "tensor2robot_tpu_torch.meta_learning.run_meta_env",
    "tensor2robot_tpu_torch.meta_learning.meta_models",
    "tensor2robot_tpu_torch.research.pose_env.pose_env_maml_models",
    "tensor2robot_tpu_torch.utils.keypath",
])
def test_the_subprocess_import_covers_the_meta_slice(module):
    """Every module of the meta-learning slice is among those the
    blocked-jax subprocess imports and the import scans parse."""
    assert module in set(_modules())
    path = ROOT / (module.replace(".", "/") + (
        "/__init__.py" if module.endswith("meta_learning") else ".py"))
    assert path in SOURCES


@pytest.mark.parametrize("module", [
    "tensor2robot_tpu_torch.utils.subsample",
    "tensor2robot_tpu_torch.utils.global_step_functions",
    "tensor2robot_tpu_torch.utils.t2r_test_fixture",
    "tensor2robot_tpu_torch.utils.train_eval_test_utils",
    "tensor2robot_tpu_torch.layers.s2d_conv",
    "tensor2robot_tpu_torch.research.qtopt.pcgrad",
    "tensor2robot_tpu_torch.data.png",
])
def test_the_subprocess_import_covers_the_single_card_remainder(module):
    """Every module of the slice that finished the single-card items
    (utilities, the space-to-depth stem, PCGrad, PNG) is among those the
    blocked-jax subprocess imports and the import scans parse."""
    assert module in set(_modules())
    path = ROOT / (module.replace(".", "/") + ".py")
    assert path in SOURCES



@pytest.mark.parametrize("module", [
    "tensor2robot_tpu_torch.parallel",
    "tensor2robot_tpu_torch.parallel.mesh",
    "tensor2robot_tpu_torch.parallel.collectives",
    "tensor2robot_tpu_torch.parallel.ring_attention",
    "tensor2robot_tpu_torch.parallel.ulysses_attention",
    "tensor2robot_tpu_torch.parallel.launch",
])
def test_the_subprocess_import_covers_the_parallel_slice(module):
    """Every module of the sequence- and data-parallel slice is among those
    the blocked-jax subprocess imports and the import scans parse."""
    assert module in set(_modules())
    path = ROOT / (module.replace(".", "/") + (
        "/__init__.py" if module.endswith("parallel") else ".py"))
    assert path in SOURCES


@pytest.mark.parametrize("module", [
    "tensor2robot_tpu_torch.export.aot",
    "tensor2robot_tpu_torch.export.artifact_store",
    "tensor2robot_tpu_torch.serving.compile_cache",
])
def test_the_subprocess_import_covers_the_aot_slice(module):
    """Every module of the AOT-package slice is among those the blocked-jax
    subprocess imports and the import scans parse."""
    assert module in set(_modules())
    path = ROOT / (module.replace(".", "/") + ".py")
    assert path in SOURCES
