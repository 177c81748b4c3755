"""The slice: both packages' serve-quant exports of the same BC weights.

The JAX package's LatestExporter and the port's, each with serve_quant
regimes over the same warmup corpus (both generators patched to return
one set of batches), on BC with 2 layers, T = 16, 16x16 images, 2 heads of
8, seed-0 weights carried across with utils/jax_params:

  * einsum heads, every regime in both packages: every attention module
    lowers (fp16 lowers nothing);
  * flash heads, the port's int8 export of the same weights (B2's plain
    version): the same dense and conv layers fire and no attention module
    lowers (as JAX's test_flash_configured_heads_never_lower_even_on_fallback
    holds its flash heads).

Held: the metadata's serve_quant block has JAX's keys; per regime the
fired layers, unlowered kernels, lowered attention modules, eligibility,
demotion, calibration mode, layout, block, granularity, payload bytes and
static-scale keys equal JAX's, the input clips within 1e-6 and the layer
clips within 1e-5 relative; and each regime's program served by the
port's ExportedModel stays within a tenth of the regime's parity tolerance
of JAX's quant serving program on a fresh batch (the JAX programs rebuilt
from StableHLO, T2R_AOT_EXPORT=0 and T2R_SERVE_AOT=0: never the AOT path,
ROADMAP C-ref1). fp8 gates are set to 1.0 in both exporters: at this tiny
random-init width JAX's fp8 defaults (0.25, 0.5) fail in both packages.
JAX's warmup records are not written (its encoder takes no float image).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.data.input_generators import (
    DefaultRandomInputGenerator as JaxRandomInputGenerator,
)
from tensor2robot_tpu.export import saved_model as jax_saved_model
from tensor2robot_tpu.export.export_generators import (
    AbstractExportGenerator as JaxAbstractExportGenerator,
)
from tensor2robot_tpu.export.exporters import LatestExporter as JaxLatestExporter
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.train.train_eval import CompiledModel
from tensor2robot_tpu_torch.export import ExportedModel, LatestExporter
from tensor2robot_tpu_torch.export import serve_quant as sq
from tensor2robot_tpu_torch.export.export_generators import AbstractExportGenerator
from tensor2robot_tpu_torch.export.saved_model import read_metadata
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.specs import make_random_numpy
from tensor2robot_tpu_torch.train.train_eval import Trainer
from tensor2robot_tpu_torch.utils.jax_params import flax_variables_to_state_dict

BC = dict(episode_length=16, image_size=(16, 16), d_model=32, num_layers=2,
          num_heads=2, head_dim=8)
LADDER = (2,)
REGIMES = ("fp16", "int8", "fp8_e4m3", "fp8_e5m2")
PARITY_TOL = {"fp8_e4m3": 1.0, "fp8_e5m2": 1.0}
#: Served outputs: a tenth of the regime's parity tolerance.
SERVED_FRACTION = 0.1
INPUT_CLIP_RTOL = 1e-6
LAYER_CLIP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Einsum heads: JAX's and the port's exports of every regime over the
    same corpus, their metadata, and each regime served by both on one
    fresh batch; then the port's int8 export of the same weights with
    flash heads."""
    jax_model = jax_models.TransformerBCModel(device_type="cpu", use_flash=False, **BC)
    generator = JaxRandomInputGenerator(batch_size=2)
    generator.set_specification_from_model(jax_model, "train")
    compiled = CompiledModel(jax_model, donate_state=False)
    state = compiled.init_state(jax.random.PRNGKey(0),
                                next(iter(generator.create_dataset("train"))))
    variables = jax.tree_util.tree_map(
        np.asarray, dict(compiled.export_variables(state, use_ema=False)))
    params = flax_variables_to_state_dict(variables)
    model = TransformerBCModel(use_flash=False, device_type="cpu", **BC)
    trainer = Trainer(model, device="cpu")
    spec = model.preprocessor.get_in_feature_specification("predict")
    corpus = [dict(make_random_numpy(spec, batch_size=b, seed=20 + b).items())
              for b in LADDER]
    root = tmp_path_factory.mktemp("slice")
    kwargs = dict(name="latest", warmup_batch_sizes=LADDER, quant_parity_tol=PARITY_TOL)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("T2R_AOT_EXPORT", "0")
        patch.setenv("T2R_SERVE_AOT", "0")
        patch.delenv("T2R_SERVE_CALIB", raising=False)
        for cls in (JaxAbstractExportGenerator, AbstractExportGenerator):
            patch.setattr(cls, "generate_warmup_batches",
                          lambda self, sizes: [dict(b) for b in corpus])
        patch.setattr(JaxAbstractExportGenerator, "write_warmup_requests",
                      lambda self, batches, path: None)
        jax_path = JaxLatestExporter(serve_quant=REGIMES, **kwargs).maybe_export(
            step=1, state=state, eval_metrics={}, compiled=compiled,
            model_dir=str(root / "jax"))
        path = LatestExporter(serve_quant=REGIMES, **kwargs).maybe_export(
            step=1, state=trainer.init_state(params=params), eval_metrics={},
            compiled=trainer, model_dir=str(root / "port"))
        batch = dict(make_random_numpy(spec, batch_size=2, seed=7).items())
        served = {}
        for regime in REGIMES:
            theirs = jax_saved_model.ExportedModel(jax_path, quant_regime=regime)
            ours = ExportedModel(path, device="cpu", quant_regime=regime)
            served[regime] = (ours.predict(batch), theirs.predict(batch))
        flash = Trainer(TransformerBCModel(use_flash=True, device_type="cpu", **BC),
                        device="cpu")
        flash_path = LatestExporter(serve_quant=("int8",), **kwargs).maybe_export(
            step=1, state=flash.init_state(params=params), eval_metrics={},
            compiled=flash, model_dir=str(root / "flash"))
    with open(os.path.join(jax_path, jax_saved_model.METADATA_FILENAME)) as f:
        theirs = json.load(f)["serve_quant"]
    return dict(ours=read_metadata(path)["serve_quant"], theirs=theirs, served=served,
                flash=read_metadata(flash_path)["serve_quant"])


def _close(got, want, rtol, what):
    assert abs(got - want) <= rtol * abs(want), (what, got, want)


def test_metadata_block_equals_jax(exports):
    ours, theirs = exports["ours"], exports["theirs"]
    assert sorted(ours) == sorted(theirs)
    assert ours["regimes"] == theirs["regimes"] == sorted(REGIMES)
    for regime in ours["regimes"]:
        native = ours["native"][regime]
        assert native == theirs["native"][regime], regime
        assert native["attention"] == ([] if regime == "fp16" else [
            "attn/encoder/block_0/attention", "attn/encoder/block_1/attention"])
        for block in ("layout", "block", "granularity", "payload_bytes", "stablehlo"):
            assert ours[block][regime] == theirs[block][regime], (block, regime)
        calib, their_calib = ours["calib"][regime], theirs["calib"][regime]
        assert calib["mode"] == their_calib["mode"]
        assert sorted(calib["demoted_to_dynamic"]) == sorted(their_calib["demoted_to_dynamic"])
        assert sorted(calib["static_scales"]) == sorted(their_calib["static_scales"])
        for key, value in their_calib["static_scales"].items():
            _close(calib["static_scales"][key], value, LAYER_CLIP_RTOL, key)
        assert sorted(ours["calibration"][regime]) == sorted(theirs["calibration"][regime])
        for key, value in theirs["calibration"][regime].items():
            _close(ours["calibration"][regime][key], value, INPUT_CLIP_RTOL, key)
    assert sorted(ours["layer_calibration"]) == sorted(theirs["layer_calibration"])
    for key, entry in theirs["layer_calibration"].items():
        assert ours["layer_calibration"][key]["samples"] == entry["samples"], key
        for stat in ("clip", "observed_max"):
            _close(ours["layer_calibration"][key][stat], entry[stat],
                   LAYER_CLIP_RTOL, (key, stat))


@pytest.mark.parametrize("regime", REGIMES)
def test_served_regime_equals_jax(exports, regime):
    ours, theirs = exports["served"][regime]
    tol = SERVED_FRACTION * sq.DEFAULT_PARITY_TOL[regime]
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        gap = float(np.abs(ours[key] - np.asarray(value)).max())
        assert gap <= tol, (regime, key, gap)


def test_flash_heads_never_lower(exports):
    """The same weights with flash heads: every dense and conv kernel
    fires as in JAX's einsum export, no attention module lowers, and the
    program's contractions are those kernels' alone."""
    native = exports["flash"]["native"]["int8"]
    assert native["layers"] == exports["theirs"]["native"]["int8"]["layers"]
    assert native["attention"] == [] and native["attention_eligibility"] == "auto"
    assert exports["flash"]["dot_audit"]["int8"] == {
        "i8": len(native["layers"]), "total": len(native["layers"])}
