"""The port's VRGripper family (research/vrgripper/) against the JAX
package's.

  * Decoders (MSE, MDN with 3 components, discrete, MAF with 1 and 2
    flows) from the same seeded variables: action and NLL within 1e-5
    abs + rel (the MAF action from the base mean; its sampled action from
    a generator inverts to the drawn base); MADE is autoregressive (its
    masks reach exactly the earlier inputs, and over 16 seeded points the
    Jacobian of shift and log-scale is strictly lower triangular with every
    allowed entry nonzero somewhere; a MADE with two degrees swapped fails
    that check); the MAF density integrates to 1 in one dimension.
  * DefaultVRGripperPreprocessor: with no generator its output equals
    JAX's with no rng (center crop, resize); Mixup with given draws (JAX's
    gamma draws and random crop patched to fixed values and the center
    crop) equals the port's apply_mixup; sample_gamma's mean and variance
    over 20000 draws within 4 standard errors for shapes 0.4 and 2.
  * Each model's outputs, loss and metrics, and one train step's
    gradient, from the same seeded variables on the same batch
    (episodes of 4 steps at 40x40, where the conv tower ends at 3x3; at
    32x32 it ends at 1x1, its feature points are constant and no gradient
    reaches it): VRGripperRegressionModel (MSE, MDN),
    VRGripperDomainAdaptiveModel (outer and inner forwards, learned and BC
    losses), VRGripperEnvTecModel (MDN, MSE, MAF and discrete decoders;
    FiLM, the end token and the contrastive loss),
    VRGripperEnvSimpleTrialModel (temporal, mean, retrial, MDN) and
    VRGripperEnvRegressionModelMAML over the regression and the
    domain-adaptive models (second order): outputs within 1e-5 abs + rel,
    each gradient within 1e-4 of its leaf's max. One second-order MAML
    gradient element against a float64 central difference (1e-6 rel).
  * pack_wtl_meta_features, make_fixed_length and the reacher and
    metareacher converters (records parsed) equal JAX's.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tensor2robot_tpu.research import vrgripper as jax_vrg
from tensor2robot_tpu.research.vrgripper import decoders as jax_decoders
from tensor2robot_tpu.specs import TensorSpecStruct as JaxStruct
from tensor2robot_tpu_torch.data.parser import decode_example
from tensor2robot_tpu_torch.research import vrgripper
from tensor2robot_tpu_torch.research.vrgripper import decoders, vrgripper_env_models
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train import train_eval
from tensor2robot_tpu_torch.utils import jax_params
from tests.test_torch_resnet import (
    GRAD_TOL,
    TOL,
    assert_close,
    assert_grads_close,
    grads_as_state_dict,
    host,
    seeded_variables,
)

T = 4
IMAGE_SIZE = (40, 40)  # the conv tower ends at 3x3: its spatial softmax moves


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _rand(*shape, seed=0, low=0.0, high=1.0):
    return np.random.RandomState(seed).uniform(low, high, shape).astype(np.float32)


# -- decoders ----------------------------------------------------------------

DECODERS = {
    "mse": (jax_decoders.MSEDecoder, decoders.MSEDecoder, {}),
    "mdn": (jax_decoders.MDNDecoder, decoders.MDNDecoder, dict(num_mixture_components=3)),
    "mdn_conditioned": (jax_decoders.MDNDecoder, decoders.MDNDecoder,
                        dict(num_mixture_components=2, condition_sigmas=True)),
    "discrete": (jax_decoders.DiscreteDecoder, decoders.DiscreteDecoder, dict(num_bins=5)),
    "maf": (jax_decoders.MAFDecoder, decoders.MAFDecoder, dict(hidden_layers=(16, 16))),
    "maf2": (jax_decoders.MAFDecoder, decoders.MAFDecoder,
             dict(num_flows=2, hidden_layers=(16, 16))),
}


def _decoder_pair(name, input_size=6, output_size=3, seed=1):
    jax_cls, cls, kwargs = DECODERS[name]
    jax_decoder, decoder = jax_cls(**kwargs), cls(input_size, output_size, **kwargs)
    params = _rand(2, 5, input_size, seed=seed, low=-1)
    shapes = jax.eval_shape(lambda: jax_decoder.init(jax.random.PRNGKey(0), params,
                                                     output_size))
    variables = seeded_variables(shapes, seed)
    jax_params.load_flax_variables(decoder, variables)
    return jax_decoder, decoder, variables, params


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_decoder_matches_jax(name):
    jax_decoder, decoder, variables, params = _decoder_pair(name)
    labels = _rand(2, 5, 3, seed=2, low=-1)
    want_action, want_aux = jax_decoder.apply(variables, params, 3, labels)
    action, aux = decoder(torch.from_numpy(params), labels=torch.from_numpy(labels))
    assert_close(action, want_action, TOL, "action")
    assert set(aux) == set(want_aux)
    for key in want_aux:
        assert_close(aux[key], want_aux[key], TOL, key)


MADE_DRAWS = 16


def _initialized_made(event_size=4, hidden=(8, 8)):
    made = decoders.MADE(event_size, hidden)
    made.apply(lambda m: m.flax_init(torch.Generator().manual_seed(0))
               if hasattr(m, "flax_init") else None)
    return made


def check_autoregressive(made, event_size=4) -> None:
    """Raises AssertionError unless every output (shift and log-scale)
    depends on exactly the strictly earlier inputs. The masks' product
    says which inputs each output can reach (a path through every masked
    layer): it must be the strict lower triangle. Then at MADE_DRAWS
    seeded points the Jacobian's upper triangle (diagonal included) is
    exactly 0, and every entry of the strict lower triangle is nonzero at
    some point: at one point dead ReLUs can zero an allowed dependence."""
    reach = None
    for i in range(made.num_hidden):
        mask = getattr(made, f"masked{i}").mask  # [out, in]
        reach = mask if reach is None else (mask @ reach > 0).float()
    reach = (made.masked_out.mask @ reach > 0).float()
    lower = torch.tril(torch.ones(event_size, event_size), -1)
    for output in (0, 1):
        rows = reach[output * event_size:(output + 1) * event_size]
        assert torch.equal(rows, lower), rows
    generator = torch.Generator().manual_seed(7)
    seen = [torch.zeros(event_size, event_size, dtype=torch.bool) for _ in (0, 1)]
    for _ in range(MADE_DRAWS):
        x = torch.randn(event_size, generator=generator)
        for output in (0, 1):
            jacobian = torch.autograd.functional.jacobian(lambda v: made(v)[output], x)
            assert torch.all(torch.triu(jacobian) == 0), jacobian
            seen[output] |= jacobian != 0
    for output in (0, 1):
        assert torch.equal(seen[output], lower.bool()), seen[output]


def test_made_is_autoregressive():
    check_autoregressive(_initialized_made())


def test_the_autoregressive_check_fails_for_a_wrong_mask(monkeypatch):
    """Input degrees with the first and last swapped (a MADE over another
    order): the check above must fail."""

    def swapped_masks(event_size, hidden_layers):
        degrees = [np.arange(1, event_size + 1)]
        degrees[0][[0, -1]] = degrees[0][[-1, 0]]
        for width in hidden_layers:
            degrees.append((np.arange(width) % max(1, event_size - 1)) + 1)
        masks = [(previous[:, None] <= current[None, :]).astype(np.float32)
                 for previous, current in zip(degrees[:-1], degrees[1:])]
        return masks, (degrees[-1][:, None] < degrees[0][None, :]).astype(np.float32)

    monkeypatch.setattr(decoders, "_made_masks", swapped_masks)
    with pytest.raises(AssertionError):
        check_autoregressive(_initialized_made())


def test_maf_density_and_sampling():
    decoder = decoders.MAFDecoder(3, 1, num_flows=2, hidden_layers=(8, 8))
    decoder.apply(lambda m: m.flax_init(torch.Generator().manual_seed(1))
                  if hasattr(m, "flax_init") else None)
    mus = torch.tensor([[0.3]])
    grid = torch.linspace(-12, 12, 4001)[:, None]
    with torch.no_grad():
        density = torch.exp(decoder.log_prob(grid, mus.expand(4001, 1)))
    assert abs(torch.trapezoid(density, grid[:, 0]).item() - 1.0) < 1e-3
    # A sampled action inverts, through the density direction, to its base.
    decoder = decoders.MAFDecoder(3, 2, num_flows=2, hidden_layers=(8, 8))
    params = torch.randn(5, 3)
    generator = torch.Generator().manual_seed(2)
    clone = torch.Generator().manual_seed(2)
    with torch.no_grad():
        action, _ = decoder(params, generator=generator)
        mus = decoder.maf_mus(params)
        base = mus + torch.randn(mus.shape, generator=clone)
        assert torch.allclose(decoder.sample_direction(base), action)
        deterministic, _ = decoder(params)
        assert not torch.allclose(deterministic, action)


# -- the preprocessor ---------------------------------------------------------


def _models(jax_cls, cls, **kwargs):
    kwargs = dict(episode_length=T, image_size=IMAGE_SIZE, device_type="cpu", **kwargs)
    return jax_cls(**kwargs), cls(**kwargs)


def _raw_episodes(batch=2, seed=0):
    rng = np.random.RandomState(seed)
    features = {"image": rng.randint(0, 256, (batch, T, 220, 300, 3)).astype(np.uint8),
                "gripper_pose": rng.standard_normal((batch, T, 14)).astype(np.float32)}
    labels = {"action": rng.standard_normal((batch, T, 7)).astype(np.float32)}
    return features, labels


def _as_torch(structure):
    return {k: torch.from_numpy(np.array(v)) for k, v in structure.items()}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_preprocessor_without_generator_matches_jax(mode):
    jax_model, model = _models(jax_vrg.VRGripperRegressionModel,
                               vrgripper.VRGripperRegressionModel)
    features, labels = _raw_episodes()
    want_f, want_l = jax_model.preprocessor.preprocess(dict(features), dict(labels),
                                                       mode=mode, rng=None)
    got_f, got_l = model.preprocessor.preprocess(_as_torch(features), _as_torch(labels),
                                                 mode=mode)
    assert set(got_f.keys()) == set(want_f.keys())
    for key in want_f.keys():
        assert_close(got_f[key], want_f[key], TOL, key)
    assert_close(got_l["action"], want_l["action"], 0.0)
    with pytest.raises(ValueError, match="lengths"):
        vrgripper.VRGripperRegressionModel(output_mean=[0.0] * 3, output_stddev=[1.0] * 3)


def test_mixup_with_given_draws_matches_jax(monkeypatch):
    from tensor2robot_tpu.preprocessors import image_transformations as jax_it

    jax_model, model = _models(jax_vrg.VRGripperRegressionModel,
                               vrgripper.VRGripperRegressionModel)
    jax_pre = jax_vrg.DefaultVRGripperPreprocessor(jax_model, mixup_alpha=0.4)
    pre = vrgripper.DefaultVRGripperPreprocessor(model, mixup_alpha=0.4)
    features, labels = _raw_episodes(batch=3, seed=1)
    draws = iter([0.3, 1.1])
    monkeypatch.setattr(jax.random, "gamma", lambda key, a: next(draws))
    monkeypatch.setattr(jax_it, "random_crop_image_batch",
                        lambda rng, images, shape: jax_it.center_crop_image_batch(images,
                                                                                  shape))
    want_f, want_l = jax_pre.preprocess(dict(features), dict(labels), mode="train",
                                        rng=jax.random.PRNGKey(0))
    got_f, got_l = pre.preprocess(_as_torch(features), _as_torch(labels), mode="eval")
    vrgripper_env_models.apply_mixup(got_f, 0.3 / 1.4)
    vrgripper_env_models.apply_mixup(got_l, 0.3 / 1.4)
    for key in ("image", "gripper_pose"):
        assert_close(got_f[key], want_f[key], TOL, key)
    assert_close(got_l["action"], want_l["action"], TOL)
    # The port's own train path draws its weight and crops from the generator.
    out_f, out_l = pre.preprocess(_as_torch(features), _as_torch(labels), mode="train",
                                  generator=torch.Generator().manual_seed(0))
    blended, original = out_l["action"], torch.from_numpy(labels["action"])
    assert not torch.allclose(blended, original)
    torch.testing.assert_close(blended + blended.flip(0), original + original.flip(0))
    assert out_f["image"].shape == (3, T) + IMAGE_SIZE + (3,)


@pytest.mark.parametrize("alpha", [0.4, 2.0])
def test_sample_gamma_statistics(alpha):
    generator = torch.Generator().manual_seed(0)
    draws = np.array([vrgripper_env_models.sample_gamma(generator, alpha)
                      for _ in range(20000)])
    assert abs(draws.mean() - alpha) < 4 * np.sqrt(alpha / 20000)
    assert abs(draws.var() - alpha) < 4 * np.sqrt((6 * alpha + 2 * alpha ** 2) / 20000)
    assert draws.min() > 0


# -- the models ---------------------------------------------------------------


def _episodes(batch=2, seed=0):
    features = JaxStruct()
    features["image"] = _rand(batch, T, *IMAGE_SIZE, 3, seed=seed)
    features["gripper_pose"] = _rand(batch, T, 14, seed=seed + 1, low=-1)
    labels = JaxStruct()
    labels["action"] = _rand(batch, T, 7, seed=seed + 2, low=-1)
    return features, labels


def _meta_episodes(tasks=2, num_condition=1, seed=0):
    features, labels = JaxStruct(), JaxStruct()
    for group, count in (("condition", num_condition), ("inference", 1)):
        features[f"{group}/features/image"] = _rand(tasks, count, T, *IMAGE_SIZE, 3,
                                                    seed=seed)
        features[f"{group}/features/gripper_pose"] = _rand(tasks, count, T, 14,
                                                           seed=seed + 1, low=-1)
        seed += 2
    features["condition/labels/action"] = _rand(tasks, num_condition, T, 7, seed=seed,
                                                low=-1)
    labels["action"] = _rand(tasks, 1, T, 7, seed=seed + 1, low=-1)
    return features, labels


def _wtl_episodes(tasks=2, num_condition=1, seed=0):
    rng = np.random.RandomState(seed)
    features, labels = JaxStruct(), JaxStruct()
    features["condition/features/full_state_pose"] = rng.standard_normal(
        (tasks, num_condition, T, 32)).astype(np.float32)
    features["condition/labels/action"] = rng.standard_normal(
        (tasks, num_condition, T, 7)).astype(np.float32)
    features["condition/labels/success"] = rng.randint(
        0, 2, (tasks, num_condition, T, 1)).astype(np.float32)
    features["inference/features/full_state_pose"] = rng.standard_normal(
        (tasks, 1, T, 32)).astype(np.float32)
    labels["action"] = rng.standard_normal((tasks, 1, T, 7)).astype(np.float32)
    labels["success"] = np.ones((tasks, 1, T, 1), np.float32)
    return features, labels


def check_model(jax_model, model, features, labels, inner=False, seed=1):
    """Outputs, loss, metrics and the gradient of one train step."""
    shapes = jax.eval_shape(lambda: jax_model.init_variables(jax.random.PRNGKey(0),
                                                             features))
    variables = seeded_variables(dict(shapes), seed)
    network = model.create_network()
    jax_params.load_flax_variables(network, variables)
    jax_forward = jax_model.inner_inference_network_fn if inner else (
        jax_model.inference_network_fn)
    jax_loss_fn = jax_model.model_inner_loop_fn if inner else jax_model.model_train_fn

    def loss_fn(params):
        outputs, _ = jax_forward(dict(variables, params=params), features, "train",
                                 labels=labels)
        loss, metrics = jax_loss_fn(features, labels, outputs, "train")
        return loss, (outputs, metrics)

    (loss, (want, want_metrics)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    want, want_metrics, grads = host((dict(want), want_metrics, grads))

    f, l, outputs, _ = model.packed_inference(network, _as_torch(features), "train",
                                              labels=_as_torch(labels))
    if inner:
        outputs, _ = model.inner_inference_network_fn(network, f, "train", labels=l)
    got_loss, metrics = (model.model_inner_loop_fn if inner else model.model_train_fn)(
        f, l, outputs, "train")
    assert set(outputs) == set(want), sorted(set(outputs) ^ set(want))
    for key, value in want.items():
        assert_close(outputs[key], value, TOL, key)
    assert set(metrics) == set(want_metrics)
    for key, value in want_metrics.items():
        assert_close(metrics[key], value, TOL, key)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=TOL, atol=TOL)
    got_loss.backward()
    assert_grads_close({k: p.grad for k, p in network.named_parameters()},
                       grads_as_state_dict(grads), GRAD_TOL)
    return network, variables


REGRESSION = {"mse": {}, "mdn": dict(num_mixture_components=3),
              "normalized": dict(output_mean=[0.1] * 7, output_stddev=[2.0] * 7,
                                 outer_loss_multiplier=0.5),
              "mdn_normalized": dict(num_mixture_components=2, normalize_outputs=True,
                                     condition_mixture_stddev=True,
                                     output_mean=[0.1] * 7, output_stddev=[2.0] * 7)}


@pytest.mark.parametrize("name", sorted(REGRESSION))
def test_regression_model_matches_jax(name):
    check_model(*_models(jax_vrg.VRGripperRegressionModel,
                         vrgripper.VRGripperRegressionModel, **REGRESSION[name]),
                *_episodes())


SAMPLE_DRAWS = 20000


def test_the_trainer_samples_the_mdn_train_action():
    """With output_mixture_sample the train action is a sample from the
    step's "net" generator, as JAX's is from its 'sample' key: two steps'
    actions differ, each equals the mixture's sample from that generator,
    and over 20000 draws the sample mean and variance of every action dim
    lie within 4 standard errors of the mixture's. The draws reach no
    loss or metric: both equal JAX's (with a sample key) within 1e-5 and
    the port's without a generator exactly."""
    jax_model, model = _models(jax_vrg.VRGripperRegressionModel,
                               vrgripper.VRGripperRegressionModel,
                               num_mixture_components=3, output_mixture_sample=True)
    features, labels = _episodes()
    shapes = jax.eval_shape(lambda: jax_model.init_variables(jax.random.PRNGKey(0),
                                                             features))
    variables = seeded_variables(dict(shapes), 1)
    outputs, _ = jax_model.inference_network_fn(variables, features, "train",
                                                rng=jax.random.PRNGKey(5), labels=labels)
    want_loss, want_metrics = host(jax_model.model_train_fn(features, labels, outputs,
                                                            "train"))
    network = model.create_network()
    jax_params.load_flax_variables(network, variables)
    trainer = train_eval.Trainer(model, device="cpu")
    seen = []
    train_fn = model.model_train_fn

    def recording(f, l, outputs, mode):
        seen.append({k: v.detach() for k, v in outputs.items()})
        return train_fn(f, l, outputs, mode)

    model.model_train_fn = recording
    f, l = TensorSpecStruct(_as_torch(features)), TensorSpecStruct(_as_torch(labels))
    runs = [trainer.backward(network, f, l, step=step) for step in (0, 1)]
    plain = trainer.backward(network, f, l)
    for loss, metrics in runs:
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL, atol=TOL)
        assert set(metrics) == set(want_metrics)
        for key, value in want_metrics.items():
            assert_close(metrics[key], value, TOL, key)
        assert loss.item() == plain[0].item()
    first, second, deterministic = seen
    assert not torch.equal(first["inference_output"], second["inference_output"])
    mixture = lambda params: vrgripper_env_models.mdn_lib.get_mixture_distribution(
        params, 3, 7)
    for step, outputs in enumerate((first, second)):
        want = mixture(outputs["dist_params"].reshape(-1, outputs["dist_params"].shape[-1]))
        drawn = want.sample(trainer.step_generator(step, "net"))
        torch.testing.assert_close(outputs["inference_output"].reshape(drawn.shape), drawn,
                                   rtol=0, atol=0)
    torch.testing.assert_close(deterministic["inference_output"],
                               mixture(deterministic["dist_params"]).approximate_mode())
    one = mixture(first["dist_params"][0, 0].expand(SAMPLE_DRAWS, -1).double())
    draws = one.sample(torch.Generator().manual_seed(0))
    weights = torch.softmax(one.logits[0], dim=-1)[:, None]
    mean = (weights * one.mus[0]).sum(0)
    variance = (weights * (one.sigmas[0] ** 2 + one.mus[0] ** 2)).sum(0) - mean ** 2
    assert torch.all((draws.mean(0) - mean).abs()
                     <= 4 * torch.sqrt(variance / SAMPLE_DRAWS))
    # The variance's standard error, from the draws' fourth central moment.
    central4 = ((draws - mean) ** 4).mean(0)
    assert torch.all((draws.var(0) - variance).abs()
                     <= 4 * torch.sqrt((central4 - variance ** 2) / SAMPLE_DRAWS))


@pytest.mark.parametrize("inner", [False, True], ids=["outer", "inner"])
def test_domain_adaptive_model_matches_jax(inner):
    check_model(*_models(jax_vrg.VRGripperDomainAdaptiveModel,
                         vrgripper.VRGripperDomainAdaptiveModel), *_episodes(), inner=inner)


def test_domain_adaptive_inner_forward_withholds_the_pose():
    """With predict_con_gripper_pose the port builds the pose predictor
    at construction and its inner forward runs; the JAX package's flax
    init runs the outer forward only, so it never creates the predictor's
    parameters and its inner forward raises (a divergence of the port)."""
    from flax.errors import ScopeParamNotFoundError

    jax_model, model = _models(jax_vrg.VRGripperDomainAdaptiveModel,
                               vrgripper.VRGripperDomainAdaptiveModel,
                               predict_con_gripper_pose=True,
                               learned_loss_conv1d_layers=None)
    features, labels = _episodes()
    variables = jax_model.init_variables(jax.random.PRNGKey(0), features)
    assert "pose_pred_fc" not in variables["params"]
    with pytest.raises(ScopeParamNotFoundError):
        jax_model.inner_inference_network_fn(variables, features, "train", labels=labels)
    network = model.init_network(torch.Generator().manual_seed(0), "cpu")
    f, l, outer, _ = model.packed_inference(network, _as_torch(features), "eval",
                                            labels=_as_torch(labels))
    inner, _ = model.inner_inference_network_fn(network, f, "eval", labels=l)
    assert not torch.allclose(outer["inference_output"], inner["inference_output"])
    zeroed = TensorSpecStruct(dict(f.items()))
    zeroed["gripper_pose"] = torch.zeros_like(f["gripper_pose"])
    again, _ = model.inner_inference_network_fn(network, zeroed, "eval")
    torch.testing.assert_close(again["inference_output"], inner["inference_output"])
    assert torch.isfinite(inner["learned_loss"])


TEC = {
    "mdn": dict(embed_loss_weight=0.1),
    "mse": dict(action_decoder_cls="MSEDecoder", predict_end_weight=0.5),
    "maf": dict(action_decoder_cls="MAFDecoder", ignore_embedding=True),
    "discrete_film": dict(action_decoder_cls="DiscreteDecoder", use_film=True,
                          embed_loss_weight=0.2),
    "mdn3_two_conditions": dict(action_decoder_cls="MDNDecoder3",
                                num_condition_samples_per_task=2),
}


def _tec_kwargs(kwargs, package):
    kwargs = dict(kwargs)
    name = kwargs.pop("action_decoder_cls", None)
    if name == "MDNDecoder3":
        if package is jax_decoders:
            kwargs["action_decoder_cls"] = lambda: jax_decoders.MDNDecoder(
                num_mixture_components=3)
        else:
            kwargs["action_decoder_cls"] = functools.partial(decoders.MDNDecoder,
                                                             num_mixture_components=3)
    elif name == "MAFDecoder":
        kwargs["action_decoder_cls"] = functools.partial(
            getattr(package, name), hidden_layers=(16, 16))
    elif name is not None:
        kwargs["action_decoder_cls"] = getattr(package, name)
    return kwargs


@pytest.mark.parametrize("name", sorted(TEC))
def test_tec_model_matches_jax(name):
    common = dict(episode_length=T, image_size=IMAGE_SIZE, device_type="cpu")
    jax_model = jax_vrg.VRGripperEnvTecModel(**common, **_tec_kwargs(TEC[name], jax_decoders))
    model = vrgripper.VRGripperEnvTecModel(**common, **_tec_kwargs(TEC[name], decoders))
    num_condition = TEC[name].get("num_condition_samples_per_task", 1)
    check_model(jax_model, model, *_meta_episodes(num_condition=num_condition))


def test_tec_preprocessor_reads_meta_example_columns():
    _, model = _models(jax_vrg.VRGripperEnvTecModel, vrgripper.VRGripperEnvTecModel)
    in_spec = model.preprocessor.get_in_feature_specification("train")
    assert tuple(in_spec["condition/features/image/0"].shape) == (T, 220, 300, 3)
    assert in_spec["condition/features/image/0"].name.startswith("condition_ep0/")


WTL = {"temporal": {}, "mean": dict(embed_type="mean"),
       "retrial": dict(retrial=True, num_condition_samples_per_task=2),
       "retrial_mean_mdn": dict(retrial=True, num_condition_samples_per_task=2,
                                embed_type="mean", num_mixture_components=3),
       "ignore_embedding": dict(ignore_embedding=True)}


@pytest.mark.parametrize("name", sorted(WTL))
def test_trial_model_matches_jax(name):
    kwargs = dict(episode_length=T, device_type="cpu", **WTL[name])
    check_model(jax_vrg.VRGripperEnvSimpleTrialModel(**kwargs),
                vrgripper.VRGripperEnvSimpleTrialModel(**kwargs),
                *_wtl_episodes(num_condition=kwargs.get("num_condition_samples_per_task", 1)))
    with pytest.raises(ValueError, match="2 condition"):
        vrgripper.VRGripperEnvSimpleTrialModel(retrial=True)


def test_pack_wtl_meta_features_matches_jax():
    state = np.arange(32, dtype=np.float32)
    success = [(state + t, np.zeros(7), 1.0, state, False, {}) for t in range(3)]
    failure = [(state - t, np.zeros(7), -1.0, state, False, {}) for t in range(6)]
    for prev in (None, [success], [failure, success]):
        want = jax_vrg.pack_wtl_meta_features(state, prev, 0, T, 2)
        got = vrgripper.pack_wtl_meta_features(state, prev, 0, T, 2)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


MAML_BASES = {"regression": (jax_vrg.VRGripperRegressionModel,
                             vrgripper.VRGripperRegressionModel),
              "domain_adaptive": (jax_vrg.VRGripperDomainAdaptiveModel,
                                  vrgripper.VRGripperDomainAdaptiveModel)}


def _maml_models(base, use_second_order=True):
    jax_base, base_model = _models(*MAML_BASES[base])
    kwargs = dict(num_inner_loop_steps=1, inner_learning_rate=0.05,
                  use_second_order=use_second_order)
    return (jax_vrg.VRGripperEnvRegressionModelMAML(base_model=jax_base, **kwargs),
            vrgripper.VRGripperEnvRegressionModelMAML(base_model=base_model, **kwargs))


@pytest.mark.parametrize("base", sorted(MAML_BASES))
def test_maml_model_matches_jax(base):
    check_model(*_maml_models(base), *_meta_episodes())


def test_maml_second_order_gradient_against_central_difference():
    """float64: d(outer loss)/d(one conv weight) through the inner step,
    against (f(w + h) - f(w - h)) / 2h."""
    _, model = _maml_models("regression")
    network = model.init_network(torch.Generator().manual_seed(0), "cpu").double()
    features, labels = _meta_episodes(seed=5)
    # float64 bypasses the specs' float32 check: the packed structures directly.
    features = TensorSpecStruct({k: torch.from_numpy(v).double() for k, v in features.items()})
    labels = TensorSpecStruct({k: torch.from_numpy(v).double() for k, v in labels.items()})

    def outer_loss():
        outputs, _ = model.inference_network_fn(network, features, "train", labels=labels)
        return model.model_train_fn(features, labels, TensorSpecStruct(outputs), "train")[0]

    weight = network.base.state_features.conv3.weight
    outer_loss().backward()
    index = np.unravel_index(int(weight.grad.abs().argmax()), tuple(weight.shape))
    analytic = weight.grad[index].item()
    h = 1e-5
    with torch.no_grad():
        weight[index] += h
        up = outer_loss().item()
        weight[index] -= 2 * h
        down = outer_loss().item()
        weight[index] += h
    numeric = (up - down) / (2 * h)
    assert abs(analytic) > 1e-6
    np.testing.assert_allclose(analytic, numeric, rtol=1e-6)


# -- episode converters --------------------------------------------------------


def _episode(length=5):
    return [(np.arange(3, dtype=np.float32) + t, np.array([1.0, -2.0], np.float32),
             float(t) - 1.5, np.arange(3, dtype=np.float32) + t + 1, t == length - 1,
             {"is_demo": True, "target_idx": 4}) for t in range(length)]


def test_make_fixed_length_matches_jax():
    module, jax_module = vrgripper.episode_to_transitions, jax_vrg.episode_to_transitions
    for length, fixed in ((10, 6), (3, 5), (2, 6), (7, 7)):
        for kwargs in (dict(randomized=False), dict(always_include_endpoints=False), {}):
            want = jax_module.make_fixed_length(list(range(length)), fixed,
                                                rng=np.random.RandomState(3), **kwargs)
            got = module.make_fixed_length(list(range(length)), fixed,
                                           rng=np.random.RandomState(3), **kwargs)
            assert got == want


def _parsed(serialized, sequence):
    features, lists = decode_example(serialized, sequence)
    flat = {k: (f.kind, np.asarray(f.values).tolist()) for k, f in features.items()}
    flat.update({k: [(f.kind, np.asarray(f.values).tolist()) for f in steps]
                 for k, steps in lists.items()})
    return flat


def test_reacher_transitions_match_jax():
    for is_demo in (False, True):
        want = jax_vrg.episode_to_transitions.episode_to_transitions_reacher(
            _episode(), is_demo=is_demo)
        got = vrgripper.episode_to_transitions.episode_to_transitions_reacher(
            _episode(), is_demo=is_demo)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert _parsed(g, False) == _parsed(w.SerializeToString(), False)


def test_metareacher_sequence_example_matches_jax():
    want = jax_vrg.episode_to_transitions.episode_to_transitions_metareacher(_episode())
    got = vrgripper.episode_to_transitions.episode_to_transitions_metareacher(_episode())
    assert len(got) == len(want) == 1
    parsed = _parsed(got[0], True)
    assert parsed == _parsed(want[0].SerializeToString(), True)
    assert len(parsed["pose_t"]) == 5 and parsed["target_idx"] == (3, [[4]])
