"""serving/compile_cache.py and the policy server's restore-tier
bookkeeping (the port's twin of tests/test_aot.py's
TestCompileTierEngagement). No package is built here: the AOT table of a
loaded version is faked where a case needs coverage.

The tier is as wide as the AOT coverage of the ladder that will SERVE: a
ladder wider than the warmup ladder (T2R_SERVE_BUCKETS, or an explicit
`batch_buckets`) has buckets off the AOT tier, and the cache must engage
for them. In the port the tier points Inductor's and Triton's on-disk
caches at the directory; the labels stay JAX's ("aot", "cache",
"compile").
"""

import os
import types

import numpy as np
import pytest
import torch

from tensor2robot_tpu_torch.export.exporters import LatestExporter
from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
from tensor2robot_tpu_torch.serving import PolicyServer
from tensor2robot_tpu_torch.serving import compile_cache
from tensor2robot_tpu_torch.train.train_eval import Trainer
from tensor2robot_tpu_torch.utils import mocks

BUCKETS = (1, 2)
_ENV = ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR", "T2R_COMPILE_CACHE_DIR",
        "T2R_SERVE_BUCKETS")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _restore_cache_env(monkeypatch):
    """enable_compile_cache writes the process environment: registering
    each variable with monkeypatch restores it after the test."""
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def export_root(tmp_path_factory):
    """A mock export with the ladder and no packages (nothing built)."""
    trainer = Trainer(mocks.MockT2RModel(device_type="cpu"), device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    exporter = LatestExporter(name="latest", warmup_batch_sizes=BUCKETS,
                              aot_executables=False)
    model_dir = str(tmp_path_factory.mktemp("cache"))
    exporter.maybe_export(step=1, state=state, eval_metrics={"loss": 1.0},
                          compiled=trainer, model_dir=model_dir)
    return exporter.export_root(model_dir)


def _covered(buckets=BUCKETS):
    """A loaded version whose packages cover its warmup ladder."""
    return types.SimpleNamespace(
        aot_covered=True, aot_enabled=True,
        aot_executables={b: object() for b in buckets},
        metadata={"warmup_batch_sizes": list(buckets)})


def _fake_aot_table(predictor, buckets=BUCKETS):
    """Marks `buckets` as served from packages on the loaded version (the
    table holds no runner, so each still runs the exported program)."""
    loaded = predictor.loaded_model
    loaded.aot_enabled = True
    loaded.aot_executables = {b: None for b in buckets}


class TestEnableCompileCache:
    def test_unset_flag_touches_nothing(self):
        assert compile_cache.enable_compile_cache() is None
        assert "TRITON_CACHE_DIR" not in os.environ

    def test_directory_points_inductor_and_triton_caches(self, tmp_path):
        assert compile_cache.enable_compile_cache(str(tmp_path)) == str(tmp_path)
        assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "inductor")
        assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "triton")
        from torch._inductor.runtime.cache_dir_utils import cache_dir

        assert cache_dir() == str(tmp_path / "inductor")

    def test_flag_resolves_the_directory(self, tmp_path, monkeypatch):
        monkeypatch.setenv("T2R_COMPILE_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # An explicit argument wins over the flag.
        other = str(tmp_path / "other")
        assert compile_cache.enable_compile_cache(other) == other


class TestCompileTierEngagement:
    def test_flag_ladder_beyond_aot_engages_cache(self, tmp_path, monkeypatch):
        monkeypatch.setenv("T2R_COMPILE_CACHE_DIR", str(tmp_path))
        loaded = _covered()
        # Resolved ladder == warmup ladder, wholly covered: skip.
        assert compile_cache.enable_compile_cache_for(loaded) is None
        assert "TRITON_CACHE_DIR" not in os.environ
        # T2R_SERVE_BUCKETS adds a bucket with no package: the tier engages.
        monkeypatch.setenv("T2R_SERVE_BUCKETS", "1,2,4")
        assert compile_cache.enable_compile_cache_for(loaded) == str(tmp_path)
        assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "triton")

    def test_uncovered_version_engages_cache(self, tmp_path, monkeypatch):
        monkeypatch.setenv("T2R_COMPILE_CACHE_DIR", str(tmp_path))
        loaded = types.SimpleNamespace(aot_covered=False, aot_executables={},
                                       metadata={"warmup_batch_sizes": [1]})
        assert compile_cache.enable_compile_cache_for(loaded) == str(tmp_path)
        assert compile_cache.enable_compile_cache_for(None) == str(tmp_path)

    def test_explicit_server_ladder_beyond_aot_engages_cache(self, export_root, tmp_path,
                                                             monkeypatch):
        monkeypatch.setenv("T2R_COMPILE_CACHE_DIR", str(tmp_path))
        predictor = ExportedSavedModelPredictor(export_dir=export_root, device="cpu")
        assert predictor.restore()
        os.environ.pop("TORCHINDUCTOR_CACHE_DIR", None)  # the restore engaged it
        _fake_aot_table(predictor)
        with PolicyServer(predictor, batch_buckets=(1, 2, 4), max_wait_ms=1).start() as server:
            snap = server.snapshot()
        # The constructor ladder's extra bucket rides the cache tier,
        # labelled so AND engaged (start() re-engages for any bucket
        # outside the AOT table).
        assert snap["prewarm_source"]["4"] == "cache"
        assert {snap["prewarm_source"][str(b)] for b in BUCKETS} == {"aot"}
        assert snap["counters"]["aot_misses"] == 1
        assert snap["counters"]["aot_hits"] == len(BUCKETS)
        assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == str(tmp_path / "inductor")

    def test_without_the_flag_off_tier_buckets_are_compile(self, export_root):
        predictor = ExportedSavedModelPredictor(export_dir=export_root, device="cpu")
        assert predictor.restore()
        with PolicyServer(predictor, max_wait_ms=1).start() as server:
            response = server.call({"x": np.zeros((3,), np.float32)}, timeout=30)
            snap = server.snapshot()
        assert snap["prewarm_source"] == {str(b): "compile" for b in BUCKETS}
        # T2R_SERVE_AOT is on by default, so every bucket off the tier is a
        # miss (as in the JAX package); nothing was declared, so nothing
        # fell back and the export has no fingerprint.
        assert snap["counters"]["aot_hits"] == 0
        assert snap["counters"]["aot_misses"] == len(BUCKETS)
        assert "aot_fallbacks" not in snap and "model_fingerprint" not in snap
        assert response.outputs["a_predicted"].shape == (1,)

    def test_serve_aot_off_counts_no_miss(self, export_root, monkeypatch):
        monkeypatch.setenv("T2R_SERVE_AOT", "0")
        predictor = ExportedSavedModelPredictor(export_dir=export_root, device="cpu")
        assert predictor.restore()
        with PolicyServer(predictor, max_wait_ms=1).start() as server:
            snap = server.snapshot()
        assert snap["prewarm_source"] == {str(b): "compile" for b in BUCKETS}
        assert snap["counters"]["aot_misses"] == 0

    def test_restore_engages_the_tier_per_incoming_version(self, export_root, monkeypatch):
        seen = []
        monkeypatch.setattr(compile_cache, "enable_compile_cache_for",
                            lambda loaded: seen.append(loaded))
        predictor = ExportedSavedModelPredictor(export_dir=export_root, device="cpu")
        assert predictor.restore()
        assert seen == [predictor.loaded_model]
