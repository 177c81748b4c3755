"""The port's low-precision serving module against the JAX package's.

tensor2robot_tpu_torch/export/serve_quant.py held to
tensor2robot_tpu/export/serve_quant.py on the same weights (carried across
with utils/jax_params) and the same inputs:

  * payload and layout: `quantize_tree` over the flax view of the port's
    state dict (`flax_variables`) in all four regimes, blockwise and
    channel leaves: values and scales equal JAX's bit for bit, the layout
    dicts equal, and `dequantize_tree` gives JAX's floats exactly;
  * eligibility: the default map, "none" and globs equal JAX's for BC and
    MockT2RModel;
  * contractions: `native_dot`, `native_conv` (SAME and VALID, stride 2),
    QK^T and PV on the same operands: int8 accumulators equal exactly,
    f32 outputs within 1e-6 relative (of the output's largest magnitude);
  * calibration: `calibrate_activations`, the capture with
    `calibrate_layer_activations` and `resolve_static_scales` give JAX's
    keys and demotions, clips within 1e-5 relative;
  * behaviour, as tests/test_serve_quant.py holds the JAX package's: a
    failing gate writes nothing, a NaN output fails it, a failing native
    module is demoted, the exporter validates its config, a missing
    regime raises naming the flag, a model-code predictor refuses a
    regime, the flags, the static program has no activation-quant reduce
    and the dynamic one has them, the server snapshot, a hot swap keeps
    the regime, and a gin binding of each new exporter keyword.

The whole-slice parity (both packages' exporters) is
tests/test_torch_serve_quant_export.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tensor2robot_tpu import flags as jax_flags
from tensor2robot_tpu.export import serve_quant as jsq
from tensor2robot_tpu.models import transformer_models as jax_models
from tensor2robot_tpu.specs import make_random_numpy as jax_make_random_numpy
from tensor2robot_tpu.train.train_eval import CompiledModel
from tensor2robot_tpu.utils import mocks as jax_mocks
from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.config import registry
from tensor2robot_tpu_torch.export import (
    ExportedModel,
    Exporter,
    LatestExporter,
    QuantParityError,
)
from tensor2robot_tpu_torch.export import exporters as exporters_lib
from tensor2robot_tpu_torch.export import serve_quant as sq
from tensor2robot_tpu_torch.export.saved_model import read_metadata
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel, _pad_same
from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor
from tensor2robot_tpu_torch.predictors.saved_model_v2_predictor import (
    SavedModelCodePredictor,
)
from tensor2robot_tpu_torch.serving import PolicyServer
from tensor2robot_tpu_torch.train.train_eval import Trainer
from tensor2robot_tpu_torch.utils import mocks
from tensor2robot_tpu_torch.utils.jax_params import load_flax_variables

BC = dict(episode_length=16, image_size=(16, 16), d_model=32, num_layers=2,
          num_heads=2, head_dim=8)
#: f32 outputs of a contraction on equal operands: the same products
#: summed in another order, relative to the output's largest magnitude.
CONTRACTION_RTOL = 1e-6
#: Calibration clips from the two packages' forwards (f32 in another
#: order), relative.
CLIP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _rel_close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.fixture(scope="module")
def bc():
    """JAX BC (einsum heads) initialized from seed 0, the port's network
    holding the same weights, and JAX's CompiledModel."""
    jax_model = jax_models.TransformerBCModel(device_type="cpu", use_flash=False, **BC)
    preprocessor = jax_model.preprocessor
    raw = jax_make_random_numpy(
        preprocessor.get_in_feature_specification("predict"), batch_size=2, seed=4)
    features, _ = preprocessor.preprocess(raw, None, mode="predict", rng=None)
    init = jax.jit(jax_model.init_variables)  # eager init takes ~15 s here
    variables = jax.tree_util.tree_map(
        np.asarray, dict(init(jax.random.PRNGKey(0), features)))
    model = TransformerBCModel(use_flash=False, device_type="cpu", **BC)
    network = model.create_network()
    load_flax_variables(network, variables)
    return dict(jax_model=jax_model, variables=variables, model=model,
                network=network, tree=sq.flax_variables(network.state_dict(), network))


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) and not sq._is_payload_node(value):
            yield from _flat(value, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), value


def _bytes(array) -> np.ndarray:
    """The storage bytes of a JAX (numpy or ml_dtypes) or torch array."""
    if isinstance(array, torch.Tensor):
        return array.contiguous().view(torch.uint8).numpy()
    array = np.ascontiguousarray(np.asarray(array))
    return array.view(np.uint8)


class TestPayload:
    def test_flax_view_is_the_jax_tree(self, bc):
        ours, theirs = dict(_flat(bc["tree"])), dict(_flat(bc["variables"]))
        assert set(ours) == set(theirs)
        for path, value in theirs.items():
            np.testing.assert_array_equal(ours[path], np.asarray(value), err_msg=path)

    @pytest.mark.parametrize("regime", sq.SERVE_QUANT_REGIMES)
    def test_quantize_tree_bit_for_bit(self, bc, regime):
        """Blockwise leaves (biases, norms, the position table) and channel
        leaves (every deep kernel in int8/fp8): equal layouts, values and
        scales equal byte for byte, the dequantized floats equal."""
        native = jsq.default_native_eligibility(bc["variables"], regime)
        assert tuple(native) == sq.default_native_eligibility(bc["tree"], regime)
        jax_payload, jax_layout = jsq.quantize_tree(bc["variables"], regime, native=native)
        payload, layout = sq.quantize_tree(bc["tree"], regime, native=native)
        assert layout == jax_layout
        granularity = {meta["granularity"] for meta in layout.values()}
        assert granularity == ({"block", "channel"} if native else {"block"})
        ours, theirs = dict(_flat(payload)), dict(_flat(jax_payload))
        assert set(ours) == set(theirs)
        for path, node in theirs.items():
            if not jsq._is_payload_node(node):
                np.testing.assert_array_equal(ours[path].numpy(), np.asarray(node))
                continue
            for key in (jsq.Q_KEY, jsq.S_KEY):
                np.testing.assert_array_equal(_bytes(ours[path][key]), _bytes(node[key]),
                                              err_msg=f"{path} {key}")
        assert sq.payload_nbytes(payload) == jsq.payload_nbytes(jax_payload)
        dequantized = dict(_flat(sq.dequantize_tree(payload, layout, regime)))
        for path, value in _flat(jsq.dequantize_tree(jax_payload, jax_layout, regime)):
            np.testing.assert_array_equal(dequantized[path].numpy(), np.asarray(value),
                                          err_msg=path)

    def test_unknown_regime_and_bad_native_path_raise(self, bc):
        with pytest.raises(ValueError, match="T2R_SERVE_QUANT"):
            sq.quantize_tree(bc["tree"], "int4")
        with pytest.raises(ValueError, match="not found"):
            sq.quantize_tree(bc["tree"], "int8", native=("params/nope/kernel",))
        with pytest.raises(ValueError, match="only"):
            sq.quantize_tree(bc["tree"], "fp16", native=("params/embed/kernel",))


class TestEligibility:
    @pytest.fixture(scope="class")
    def mock_trees(self):
        jax_model = jax_mocks.MockT2RModel(device_type="cpu")
        variables = jax.tree_util.tree_map(np.asarray, dict(
            jax_model.init_variables(jax.random.PRNGKey(0),
                                     {"x": np.zeros((2, 3), np.float32)})))
        model = mocks.MockT2RModel(device_type="cpu")
        network = model.create_network()
        load_flax_variables(network, variables)
        return variables, sq.flax_variables(network.state_dict(), network)

    @pytest.mark.parametrize("override", [None, "auto", "none", "params/encoder/*",
                                          "*mlp*,*Dense_2*", "params/Conv_?/kernel"])
    @pytest.mark.parametrize("regime", sq.SERVE_QUANT_REGIMES)
    def test_maps_equal_jax(self, bc, mock_trees, regime, override, monkeypatch):
        monkeypatch.delenv("T2R_SERVE_NATIVE_LAYERS", raising=False)
        for theirs, ours in ((bc["variables"], bc["tree"]), mock_trees):
            want = jsq.resolve_native_eligibility(theirs, regime, override=override)
            assert sq.resolve_native_eligibility(ours, regime, override=override) == tuple(want)

    def test_flag_override_and_attention_spec(self, bc, monkeypatch):
        monkeypatch.setenv("T2R_SERVE_NATIVE_LAYERS", "none")
        assert sq.resolve_native_eligibility(bc["tree"], "int8") == ()
        for value, want in ((None, "auto"), ("none", ()), ("a/*, b", ("a/*", "b"))):
            if value is None:
                monkeypatch.delenv("T2R_SERVE_NATIVE_ATTN", raising=False)
            else:
                monkeypatch.setenv("T2R_SERVE_NATIVE_ATTN", value)
            assert sq.resolve_native_attention() == want == jsq.resolve_native_attention()


def _quantized_kernel(w: np.ndarray, regime: str):
    tree = {"params": {"k": {"kernel": w}}}
    node = jsq.quantize_tree(tree, regime, native=("params/k/kernel",))[0]["params"]["k"]["kernel"]
    ours = sq.quantize_tree(tree, regime, native=("params/k/kernel",))[0]["params"]["k"]["kernel"]
    return node, ours


class TestContractions:
    @pytest.mark.parametrize("a_clip", [None, 2.5])
    @pytest.mark.parametrize("regime", sq.NATIVE_DOT_REGIMES)
    def test_native_dot(self, regime, a_clip):
        rng = np.random.RandomState(0)
        x = rng.randn(2, 5, 48).astype(np.float32)
        w = rng.randn(48, 24).astype(np.float32)
        jax_node, node = _quantized_kernel(w, regime)
        want = jsq.native_dot(jnp.asarray(x), jnp.asarray(jax_node[jsq.Q_KEY]),
                              jnp.asarray(jax_node[jsq.S_KEY]), regime, a_clip=a_clip)
        got = sq.native_dot(torch.from_numpy(x), node[sq.Q_KEY], node[sq.S_KEY], regime,
                            a_clip=a_clip)
        _rel_close(got.numpy(), np.asarray(want), CONTRACTION_RTOL)

    def test_int8_accumulators_are_exact(self):
        """The same int8 operands: JAX's int32 dot_general and the port's
        `_int_mm` route (padded) give the same integers, the dense shape
        and the attention slices' shapes alike."""
        rng = np.random.RandomState(1)
        for m, k, n in ((5, 27, 7), (33, 48, 24), (16, 8, 16), (16, 16, 8)):
            a = rng.randint(-127, 128, (m, k)).astype(np.int8)
            b = rng.randint(-127, 128, (k, n)).astype(np.int8)
            want = lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
            got = sq.quant_mm(torch.from_numpy(a), torch.from_numpy(b))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            batched = sq.quant_bmm(torch.from_numpy(np.stack([a, a])),
                                   torch.from_numpy(np.stack([b, b])))
            np.testing.assert_array_equal(batched.numpy(), np.stack([np.asarray(want)] * 2))

    @pytest.mark.parametrize("padding", ["SAME", "VALID"])
    @pytest.mark.parametrize("regime", sq.NATIVE_DOT_REGIMES)
    def test_native_conv(self, regime, padding):
        """Stride 2 over NHWC in JAX, NCHW in the port (SAME as XLA pads it:
        the port's convs pad before the call, as BC's do)."""
        rng = np.random.RandomState(2)
        x = rng.randn(3, 9, 10, 4).astype(np.float32)
        w = rng.randn(3, 3, 4, 8).astype(np.float32)
        jax_node, node = _quantized_kernel(w, regime)
        want = jsq.native_conv(jnp.asarray(x), jnp.asarray(jax_node[jsq.Q_KEY]),
                               jnp.asarray(jax_node[jsq.S_KEY]), regime, strides=(2, 2),
                               padding=padding)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        if padding == "SAME":
            xt = _pad_same(xt, 3, 2)
        got = sq.native_conv(xt, node[sq.Q_KEY], node[sq.S_KEY], regime, stride=2)
        _rel_close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), CONTRACTION_RTOL)

    @pytest.mark.parametrize("static", [False, True])
    @pytest.mark.parametrize("regime", sq.NATIVE_DOT_REGIMES)
    def test_attention_contractions(self, regime, static):
        rng = np.random.RandomState(3)
        q, k, v = (rng.randn(2, 16, 2, 8).astype(np.float32) for _ in range(3))
        logits = rng.randn(2, 2, 16, 16).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        key = "attn/encoder/block_0/attention"
        scales = {f"{key}:{o}": c for o, c in (("q", 2.0), ("k", 2.5), ("v", 1.5))} \
            if static else {}
        theirs = jsq._QuantAttentionContraction(regime, static_scales=scales)
        theirs.path_key = key
        ours = sq._QuantAttentionContraction(regime, key, static_scales=scales)
        _rel_close(ours.qk(torch.from_numpy(q), torch.from_numpy(k), 0.35).numpy(),
                   np.asarray(theirs.qk(jnp.asarray(q), jnp.asarray(k), 0.35)),
                   CONTRACTION_RTOL)
        _rel_close(ours.pv(torch.from_numpy(probs), torch.from_numpy(v)).numpy(),
                   np.asarray(theirs.pv(jnp.asarray(probs), jnp.asarray(v))),
                   CONTRACTION_RTOL)

    def test_flash_heads_never_take_the_override(self):
        """Inside a quantized override, the flash path (B2's plain version
        here) computes the f32 attention; the einsum path takes it."""
        from tensor2robot_tpu_torch.ops import flash_attention as fa

        q = torch.randn(1, 16, 2, 16, generator=torch.Generator().manual_seed(0))
        impl = sq._QuantAttentionContraction("int8", "attn/x", fired=set())
        plain = fa.flash_attention(q, q, q, causal=True)
        with fa.attention_contraction_override(impl):
            flash = fa.flash_attention(q, q, q, causal=True)
            einsum = fa.reference_attention(q, q, q, causal=True)
        torch.testing.assert_close(flash, plain, rtol=0, atol=0)
        assert impl._fired == {"attn/x"}
        assert not torch.equal(einsum, fa.reference_attention(q, q, q, causal=True))


class TestCalibration:
    def test_input_clips_equal_jax(self):
        rng = np.random.RandomState(4)
        batches = [{"a": rng.randn(4, 7).astype(np.float32) * 3,
                    "b": rng.randint(0, 9, (4, 2)).astype(np.int32),
                    "z": np.zeros((4, 3), np.float32)} for _ in range(3)]
        assert sq.calibrate_activations(batches) == jsq.calibrate_activations(batches)
        with pytest.raises(sq.CalibrationError):
            sq.calibrate_activations([])
        with pytest.raises(sq.CalibrationError, match="'a'"):
            sq.calibrate_activations([{"a": np.full((2,), np.nan, np.float32)}])

    def test_fake_quant_equals_jax(self):
        x = np.linspace(-4, 4, 97, dtype=np.float32)
        for regime in sq.SERVE_QUANT_REGIMES:
            want = jsq.fake_quant_activations({"x": jnp.asarray(x)}, {"x": 3.0}, regime)
            got = sq.fake_quant_activations({"x": torch.from_numpy(x)}, {"x": 3.0}, regime)
            np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))

    def test_layer_clips_and_demotions_equal_jax(self):
        rng = np.random.RandomState(5)
        records = {"params/a/kernel": [np.abs(rng.randn(5000)).astype(np.float32)],
                   "params/b/kernel": [np.abs(rng.randn(3000)).astype(np.float32),
                                       np.array([40.0], np.float32)],
                   "attn/x:q": [np.zeros(8, np.float32)]}
        ours = sq.calibrate_layer_activations(records)
        assert ours == jsq.calibrate_layer_activations(records)
        assert sq.resolve_static_scales(ours) == jsq.resolve_static_scales(ours)
        assert "params/b/kernel" in sq.resolve_static_scales(ours)[1]
        with pytest.raises(sq.CalibrationError, match="params/a/kernel"):
            sq.calibrate_layer_activations({"params/a/kernel": [np.array([np.inf])]})

    def test_capture_equals_jax(self, bc):
        """The eager fp32 forward of BC (einsum heads) over a batch of 8
        episodes: the same keys (every dense and conv input, every
        attention module's q, k, v), Conv_0's pool past the per-call cap
        stride-subsampled as JAX's, clips and maxima within 1e-5."""
        batch = jax_make_random_numpy(
            bc["jax_model"].preprocessor.get_in_feature_specification("predict"),
            batch_size=8, seed=6)
        batch = dict(batch.items())
        compiled = CompiledModel(bc["jax_model"], donate_state=False)
        from tensor2robot_tpu.export.export_generators import (
            DefaultExportGenerator as JaxExportGenerator,
        )
        generator = JaxExportGenerator()
        generator.set_specification_from_model(bc["jax_model"])
        eager = generator.create_eager_serving_fn(compiled, bc["variables"])
        theirs: dict = {}
        with jsq.capture_activations(theirs):
            eager(batch)
        from tensor2robot_tpu_torch.export.export_generators import DefaultExportGenerator
        port_generator = DefaultExportGenerator()
        port_generator.set_specification_from_model(bc["model"])
        module = port_generator.create_eager_serving_fn(
            bc["network"].state_dict(), device=torch.device("cpu"))
        ours: dict = {}
        with sq.capture_activations(ours, module.network), torch.no_grad():
            module({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
        assert set(ours) == set(theirs)
        assert any(k.startswith("attn/") for k in ours)
        assert ours["params/Conv_0/kernel"][0].size == theirs["params/Conv_0/kernel"][0].size
        assert ours["params/Conv_0/kernel"][0].size < 8 * 16 * 16 * 16 * 3
        mine = sq.calibrate_layer_activations(ours)
        for key, entry in jsq.calibrate_layer_activations(theirs).items():
            assert mine[key]["samples"] == entry["samples"], key
            for stat in ("clip", "observed_max"):
                assert abs(mine[key][stat] - entry[stat]) <= CLIP_RTOL * entry[stat], key
        assert sorted(sq.resolve_static_scales(mine)[1]) == sorted(
            jsq.resolve_static_scales(jsq.calibrate_layer_activations(theirs))[1])


# -- behaviour, on the port's MockT2RModel ----------------------------------------

LADDER = (1, 2, 4)


@pytest.fixture(scope="module")
def trained():
    model = mocks.MockT2RModel(device_type="cpu")
    trainer = Trainer(model, device="cpu")
    return model, trainer, trainer.init_state(torch.Generator().manual_seed(0))


def _export(trained, model_dir, **kwargs):
    _, trainer, state = trained
    exporter = LatestExporter(name="latest", warmup_batch_sizes=LADDER, **kwargs)
    path = exporter.maybe_export(step=1, state=state, eval_metrics={"loss": 1.0},
                                 compiled=trainer, model_dir=str(model_dir))
    return path, exporter.export_root(str(model_dir))


@pytest.fixture(scope="module")
def quant_export(trained, tmp_path_factory):
    return _export(trained, tmp_path_factory.mktemp("quant"),
                   serve_quant=("fp16", "int8"))


class TestBehaviour:
    def test_failing_gate_writes_nothing(self, trained, tmp_path):
        with pytest.raises(QuantParityError, match="int8"):
            _export(trained, tmp_path, serve_quant=("int8",),
                    quant_parity_tol={"int8": 1e-9})
        root = os.path.join(tmp_path, "export", "latest")
        assert not os.path.exists(root) or not os.listdir(root)

    def test_nan_output_fails_the_gate(self):
        divergence = sq.measure_parity([{"a": np.zeros(3)}],
                                       [{"a": np.array([0.0, np.nan, 0.0])}])
        assert divergence == {"a": float("inf")}
        with pytest.raises(QuantParityError, match="a=inf"):
            sq.check_parity("int8", divergence, 10.0)

    def test_failing_native_module_demotes_to_dequant(self):
        class Fn:
            quant_payload = {}
            device = "cpu"

            def __init__(self, out):
                self.out = out

            def __call__(self, payload, features):
                return {"a": torch.full((1,), self.out)}

        rebuilt = Fn(0.0)
        fn, demoted = exporters_lib._native_pre_gate(
            Fn(5.0), lambda: rebuilt, [{"a": np.zeros(1)}], [{"x": np.zeros(1)}], 0.1)
        assert demoted and fn is rebuilt and fn.quant_native_demoted
        fn, demoted = exporters_lib._native_pre_gate(
            Fn(0.05), lambda: rebuilt, [{"a": np.zeros(1)}], [{"x": np.zeros(1)}], 0.1)
        assert not demoted and fn.quant_measured_divergence == {"a": pytest.approx(0.05)}

    def test_exporter_validates_its_config(self):
        for kwargs, match in (
                (dict(serve_quant=("int4",), warmup_batch_sizes=(1,)), "among"),
                (dict(serve_quant=("int8",)), "warmup_batch_sizes"),
                (dict(serve_quant=("int8",), warmup_batch_sizes=(1,),
                      quantize_weights=True), "quantize_weights"),
                (dict(serve_quant=("int8",), warmup_batch_sizes=(1,),
                      serialize_stablehlo=False), "serialize_stablehlo"),
                (dict(serve_calib="sometimes"), "T2R_SERVE_CALIB"),
                (dict(export_program=True, serialize_stablehlo=False), "disagree"),
                # AOT packages are ported (A10.2): JAX's config-time checks.
                (dict(aot_executables=True), "warmup_batch_sizes"),
                (dict(aot_executables=True, warmup_batch_sizes=(1,),
                      serialize_stablehlo=False), "serialize_stablehlo")):
            with pytest.raises(ValueError, match=match):
                Exporter("x", **kwargs)

    def test_metadata_and_served_regimes(self, quant_export):
        path, _ = quant_export
        meta = read_metadata(path)["serve_quant"]
        assert meta["regimes"] == ["fp16", "int8"]
        assert meta["stablehlo"] == {"fp16": True, "int8": True}
        assert meta["native"]["int8"]["layers"] == ["params/Dense_1/kernel",
                                                   "params/Dense_2/kernel"]
        assert meta["dot_audit"]["int8"] == {"f32": 1, "i8": 2, "total": 3}
        assert meta["calib"]["int8"]["mode"] == "static"
        assert meta["reduce_audit"]["int8"]["activation_quant_reduces"] == 0
        features = {"x": np.random.RandomState(0).randn(3, 3).astype(np.float32)}
        want = ExportedModel(path, device="cpu", quant_regime="none").predict(features)
        for regime in meta["regimes"]:
            loaded = ExportedModel(path, device="cpu", quant_regime=regime)
            assert loaded.quant_regime == regime and loaded.has_program
            got = loaded.predict(features)
            for key, value in want.items():
                assert np.abs(got[key] - value).max() <= sq.DEFAULT_PARITY_TOL[regime]

    def test_dynamic_program_has_the_activation_quant_reduces(self, trained, tmp_path):
        path, _ = _export(trained, tmp_path, serve_quant=("int8",), serve_calib="dynamic")
        meta = read_metadata(path)["serve_quant"]
        assert meta["calib"]["int8"]["mode"] == "dynamic"
        # One per-row max reduce per lowered dense layer.
        assert meta["reduce_audit"]["int8"]["activation_quant_reduces"] == 2

    def test_missing_regime_raises_naming_the_flag(self, quant_export, monkeypatch):
        path, _ = quant_export
        with pytest.raises(ValueError, match="T2R_SERVE_QUANT=fp8_e5m2"):
            ExportedModel(path, device="cpu", quant_regime="fp8_e5m2")
        monkeypatch.setenv("T2R_SERVE_QUANT", "fp8_e4m3")
        with pytest.raises(ValueError, match="T2R_SERVE_QUANT=fp8_e4m3"):
            ExportedModel(path, device="cpu")

    def test_model_code_predictor_refuses_a_regime(self, quant_export, monkeypatch):
        _, root = quant_export
        monkeypatch.setenv("T2R_SERVE_QUANT", "int8")
        predictor = SavedModelCodePredictor(root, mocks.MockT2RModel(device_type="cpu"),
                                            device="cpu")
        with pytest.raises(ValueError, match="cannot honor quant regime"):
            predictor.restore()

    def test_flags_declared_with_jax_defaults(self, monkeypatch):
        for name in ("T2R_SERVE_QUANT", "T2R_SERVE_CALIB", "T2R_SERVE_NATIVE_LAYERS",
                     "T2R_SERVE_NATIVE_ATTN"):
            ours, theirs = flags.get_flag(name), jax_flags.get_flag(name)
            assert (ours.kind, ours.default, ours.choices) == (
                theirs.kind, theirs.default, theirs.choices)
        assert flags.get_enum("T2R_SERVE_QUANT") == "none"
        monkeypatch.setenv("T2R_SERVE_QUANT", "int4")
        with pytest.raises(ValueError, match="T2R_SERVE_QUANT"):
            flags.get_enum("T2R_SERVE_QUANT")

    def test_server_snapshot_and_hot_swap_keep_the_regime(self, trained, tmp_path):
        _, trainer, state = trained
        exporter = LatestExporter(name="latest", warmup_batch_sizes=(1, 2),
                                  serve_quant=("int8",))
        exporter.maybe_export(step=1, state=state, eval_metrics={"loss": 1.0},
                              compiled=trainer, model_dir=str(tmp_path))
        root = exporter.export_root(str(tmp_path))
        predictor = ExportedSavedModelPredictor(export_dir=root, device="cpu",
                                                quant_regime="int8")
        assert predictor.restore()
        v1 = predictor.model_version
        with PolicyServer(predictor, max_wait_ms=1).start() as server:
            snap = server.snapshot()
            assert snap["serve_quant"] == "int8"
            assert snap["serve_quant_native_layers"] == ["params/Dense_1/kernel",
                                                         "params/Dense_2/kernel"]
            assert snap["serve_quant_calib"] == "static"
            assert snap["serve_quant_reduce_audit"]["activation_quant_reduces"] == 0
            exporter.maybe_export(step=2, state=state, eval_metrics={"loss": 0.9},
                                  compiled=trainer, model_dir=str(tmp_path))
            assert server.hot_swap(wait=True)
            response = server.call({"x": np.zeros((3,), np.float32)}, timeout=60)
        assert response.model_version > v1
        assert predictor.quant_regime == "int8"
        assert np.all(np.isfinite(response.outputs["a_predicted"]))

    @pytest.mark.parametrize("binding", [
        "serialize_stablehlo = True", "quant_block = 256", "quant_min_size = 32",
        "quant_parity_tol = {'int8': 0.3}", "serve_calib = 'dynamic'",
        "serve_quant = ('fp16',)"])
    def test_gin_binding_of_each_exporter_keyword(self, binding):
        """Each keyword binds on LatestExporter; those of JAX's
        create_default_exporters (no quant_block, no quant_min_size) on it."""
        import tensor2robot_tpu_torch.config.defaults  # noqa: F401 — registers

        targets = ["LatestExporter"]
        if not binding.startswith(("quant_block", "quant_min_size")):
            targets.append("create_default_exporters")
        for target in targets:
            registry.clear_config()
            try:
                registry.parse_config(f"{target}.{binding}\n"
                                      f"{target}.warmup_batch_sizes = (1,)")
                made = (registry.get_configurable(target)(name="x")
                        if target == "LatestExporter"
                        else registry.get_configurable(target)(None))
                assert made
            finally:
                registry.clear_config()
