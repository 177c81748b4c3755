"""The port's TEC, MDN and SNAIL layers and spatial softmax's Gumbel mode
against the JAX package's.

  * Each module from the same seeded variables (carried over with
    utils/jax_params.load_flax_variables): EmbedFullstate,
    EmbedConditionImages (feature points with fc layers, feature maps
    with 1x1 convs), ReduceTemporalEmbeddings in its three combine modes
    and on [N, T, h, w, F] maps, MDNParams (learned and conditioned
    sigmas), MDNDecoder, CausalConv, DenseBlock, TCBlock and
    AttentionBlock: outputs within 1e-5 abs + rel, and for the TEC
    reducer and SNAIL's TCBlock the gradient of a loss of the output
    within 1e-4 of each leaf's max.
  * contrastive_loss, triplet_semihard_loss (labels with repeats and with
    no semi-hard negative) and compute_embedding_contrastive_loss in all
    five modes; GaussianMixture's log_prob, approximate_mode and mean,
    get_mixture_distribution with an output mean, mdn_loss,
    causally_masked_softmax: within 1e-5.
  * GaussianMixture.sample from a generator: component frequencies within
    4 standard errors of the mixture weights and per-component moments
    near (mu, sigma), over 20000 draws.
  * Spatial softmax's Gumbel mode: with given noise g, the port on
    features + T * g equals JAX's deterministic mode on the same input;
    the port's sampled mode equals the port on features + T * g with g
    drawn from a clone of the generator.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor2robot_tpu.layers import mdn as jax_mdn
from tensor2robot_tpu.layers import snail as jax_snail
from tensor2robot_tpu.layers import tec as jax_tec
from tensor2robot_tpu_torch.layers import mdn, snail, tec
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

# The packages export the function spatial_softmax under the module's name.
jax_ss = importlib.import_module("tensor2robot_tpu.layers.spatial_softmax")
spatial_softmax = importlib.import_module("tensor2robot_tpu_torch.layers.spatial_softmax")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def carry_over(jax_module, port_module, *inputs, seed=1, **kwargs):
    """Seeded variables for `jax_module` on `inputs`, loaded into
    `port_module`; returns the variables."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), *inputs,
                                                    **kwargs))
    variables = seeded_variables(shapes, seed)
    jax_params.load_flax_variables(port_module, variables)
    return variables


def check_forward(jax_module, port_module, *inputs, grad=False, **kwargs):
    variables = carry_over(jax_module, port_module, *inputs, **kwargs)
    want = jax_module.apply(variables, *inputs, **kwargs)
    got = port_module(*[torch.from_numpy(x) for x in inputs], **kwargs)
    jax.tree_util.tree_map(lambda g, w: assert_close(g, w, TOL), got, want)
    if grad:
        def loss_fn(params):
            out = jax_module.apply(dict(variables, params=params), *inputs, **kwargs)
            return jnp.sum(jnp.sin(out))

        grads = host(jax.grad(loss_fn)(variables["params"]))
        torch.sum(torch.sin(got)).backward()
        assert_grads_close({k: p.grad for k, p in port_module.named_parameters()},
                           grads_as_state_dict(grads), GRAD_TOL)


# -- TEC ---------------------------------------------------------------------


def test_embed_fullstate():
    check_forward(jax_tec.EmbedFullstate(embed_size=8, fc_layers=(12, 10)),
                  tec.EmbedFullstate(6, 8, fc_layers=(12, 10)), _rand(5, 6))


@pytest.mark.parametrize("spatial_softmax_on", [True, False])
def test_embed_condition_images(spatial_softmax_on):
    images = np.random.RandomState(2).uniform(0, 1, (2, 40, 40, 3)).astype(np.float32)
    check_forward(
        jax_tec.EmbedConditionImages(fc_layers=(16, 8), use_spatial_softmax=spatial_softmax_on),
        tec.EmbedConditionImages(fc_layers=(16, 8), use_spatial_softmax=spatial_softmax_on),
        images, train=False)


@pytest.mark.parametrize("combine_mode", ["temporal_conv", "temporal_conv_avg_after",
                                          "mean"])
def test_reduce_temporal_embeddings(combine_mode):
    kwargs = dict(conv1d_layers=(7, 5), fc_hidden_layers=(9,), combine_mode=combine_mode,
                  conv1d_kernel=3)
    check_forward(jax_tec.ReduceTemporalEmbeddings(output_size=4, **kwargs),
                  tec.ReduceTemporalEmbeddings(6, 4, 8, **kwargs), _rand(3, 8, 6), grad=True)


def test_reduce_temporal_embeddings_over_maps():
    check_forward(jax_tec.ReduceTemporalEmbeddings(output_size=4, conv1d_kernel=3),
                  tec.ReduceTemporalEmbeddings(6, 4, 5, conv1d_kernel=3),
                  _rand(2, 5, 3, 3, 6))
    with pytest.raises(ValueError, match="conv1d_kernel"):
        tec.ReduceTemporalEmbeddings(6, 4, 5, conv1d_kernel=10)


def test_contrastive_and_triplet_losses():
    anchor, embeddings = _rand(1, 6, seed=3), _rand(5, 6, seed=4)
    labels = np.array([True, False, True, False, False])
    assert_close(tec.contrastive_loss(torch.from_numpy(labels), torch.from_numpy(anchor),
                                      torch.from_numpy(embeddings), margin=2.0),
                 jax_tec.contrastive_loss(labels, anchor, embeddings, margin=2.0), TOL)
    embeddings = _rand(8, 5, seed=5)
    for labels in (np.array([0, 1, 1, 2, 2, 2, 3, 0]), np.arange(8) % 2,
                   np.zeros(8, np.int64)):
        for margin in (1.0, 3.0):
            assert_close(
                tec.triplet_semihard_loss(torch.from_numpy(labels),
                                          torch.from_numpy(embeddings), margin),
                jax_tec.triplet_semihard_loss(labels, embeddings, margin), TOL)


@pytest.mark.parametrize("mode", ["default", "both_directions", "reverse_direction",
                                  "cross_entropy", "triplet"])
def test_compute_embedding_contrastive_loss(mode):
    def normalized(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    inf, con = normalized(_rand(4, 2, 6, seed=6)), normalized(_rand(4, 3, 6, seed=7))
    want = jax_tec.compute_embedding_contrastive_loss(inf, con, contrastive_loss_mode=mode)
    got = tec.compute_embedding_contrastive_loss(torch.from_numpy(inf),
                                                 torch.from_numpy(con),
                                                 contrastive_loss_mode=mode)
    assert_close(got, want, TOL)
    positives = np.array([True, True, False, False])
    want = jax_tec.compute_embedding_contrastive_loss(inf, con, positives, mode)
    got = tec.compute_embedding_contrastive_loss(
        torch.from_numpy(inf), torch.from_numpy(con), torch.from_numpy(positives), mode)
    assert_close(got, want, TOL)
    with pytest.raises(ValueError, match="shape"):
        tec.compute_embedding_contrastive_loss(torch.zeros(4, 6), torch.from_numpy(con))


# -- MDN ---------------------------------------------------------------------


def _mixture_params(seed=8, batch=(3, 4), k=3, d=2):
    return _rand(*batch, k + 2 * k * d, seed=seed)


def test_gaussian_mixture_matches_jax():
    params = _mixture_params()
    output_mean = _rand(2, seed=9)
    for mean in (None, output_mean):
        want = jax_mdn.get_mixture_distribution(params, 3, 2, mean)
        got = mdn.get_mixture_distribution(torch.from_numpy(params), 3, 2,
                                           None if mean is None else torch.from_numpy(mean))
        x = _rand(3, 4, 2, seed=10)
        assert_close(got.log_prob(torch.from_numpy(x)), want.log_prob(x), TOL)
        assert_close(got.approximate_mode(), want.approximate_mode(), TOL)
        assert_close(got.mean(), want.mean(), TOL)
        assert_close(mdn.mdn_loss(got, torch.from_numpy(x)), jax_mdn.mdn_loss(want, x), TOL)
    with pytest.raises(ValueError, match="unexpected size"):
        mdn.get_mixture_distribution(torch.zeros(2, 7), 3, 2)


@pytest.mark.parametrize("condition_sigmas", [False, True])
def test_mdn_params_and_decoder(condition_sigmas):
    x = _rand(2, 5, 6, seed=11)
    check_forward(jax_mdn.MDNParams(num_alphas=3, sample_size=2,
                                    condition_sigmas=condition_sigmas),
                  mdn.MDNParams(6, 3, 2, condition_sigmas), x)
    jax_decoder = jax_mdn.MDNDecoder(num_mixture_components=3)
    decoder = mdn.MDNDecoder(6, 2, num_mixture_components=3)
    variables = carry_over(jax_decoder, decoder, x, 2)
    want_action, want_gm = jax_decoder.apply(variables, x, 2)
    action, gm = decoder(torch.from_numpy(x))
    assert_close(action, want_action, TOL)
    assert_close(gm.sigmas, want_gm.sigmas, TOL)


def test_mixture_sampler_statistics():
    logits = torch.tensor([0.0, 1.0, -0.5])
    mus = torch.tensor([[-20.0, 0.0], [0.0, 20.0], [20.0, -20.0]])
    sigmas = torch.tensor([[0.5, 0.5], [1.0, 0.2], [0.3, 2.0]])
    n = 20000
    gm = mdn.GaussianMixture(logits.expand(n, 3), mus.expand(n, 3, 2),
                             sigmas.expand(n, 3, 2))
    draws = gm.sample(torch.Generator().manual_seed(0))
    component = torch.argmin(torch.cdist(draws, mus), dim=1)  # well separated
    weights = torch.softmax(logits, 0)
    for k in range(3):
        share = (component == k).float().mean()
        stderr = torch.sqrt(weights[k] * (1 - weights[k]) / n)
        assert abs(share - weights[k]) < 4 * stderr
        picked = draws[component == k]
        assert torch.allclose(picked.mean(0), mus[k], atol=0.1)
        assert torch.allclose(picked.std(0), sigmas[k], rtol=0.1)
    again = gm.sample(torch.Generator().manual_seed(0))
    assert torch.equal(draws, again)


# -- SNAIL -------------------------------------------------------------------


def test_causal_conv_dense_block_and_tc_block():
    x = _rand(2, 7, 4, seed=12)
    check_forward(jax_snail.CausalConv(filters=5, dilation_rate=2),
                  snail.CausalConv(4, 5, dilation_rate=2), x)
    check_forward(jax_snail.DenseBlock(filters=3, dilation_rate=4),
                  snail.DenseBlock(4, 3, dilation_rate=4), x)
    port = snail.TCBlock(4, 7, 3)
    check_forward(jax_snail.TCBlock(sequence_length=7, filters=3), port, x, grad=True)
    assert port.out_channels == 4 + 3 * 3


def test_causal_conv_is_causal():
    conv = snail.CausalConv(2, 3, dilation_rate=2)
    x = torch.randn(1, 9, 2)
    changed = x.clone()
    changed[:, 5:] += 1.0
    with torch.no_grad():
        assert torch.equal(conv(x)[:, :5], conv(changed)[:, :5])


def test_attention_block_and_masked_softmax():
    x = _rand(2, 6, 5, seed=13)
    jax_block = jax_snail.AttentionBlock(key_size=4, value_size=3)
    block = snail.AttentionBlock(5, 4, 3)
    variables = carry_over(jax_block, block, x)
    want, want_ends = jax_block.apply(variables, x)
    got, ends = block(torch.from_numpy(x))
    assert_close(got, want, TOL)
    assert_close(ends["attn_prob"], want_ends["attn_prob"], TOL)
    assert torch.all(torch.triu(ends["attn_prob"], diagonal=1) == 0)
    logits = _rand(3, 5, 5, seed=14)
    assert_close(snail.causally_masked_softmax(torch.from_numpy(logits)),
                 jax_snail.causally_masked_softmax(logits), TOL)


# -- spatial softmax's Gumbel mode ---------------------------------------------


def test_spatial_softmax_gumbel_mode():
    features = _rand(2, 5, 6, 3, seed=15)
    temperature = 0.7
    # The noise in the logits' [B * C, H * W] layout, laid out as features.
    g = spatial_softmax.draw_gumbel(torch.Generator().manual_seed(3), (2 * 3, 5 * 6),
                                    torch.float32, "cpu")
    g_nhwc = g.reshape(2, 3, 5, 6).permute(0, 2, 3, 1).numpy()
    shifted = features + temperature * g_nhwc
    want = jax_ss.spatial_softmax(jnp.asarray(shifted), temperature)
    got = spatial_softmax.spatial_softmax(torch.from_numpy(shifted), temperature)
    for g_, w in zip(got, want):
        assert_close(g_, w, TOL)

    generator = torch.Generator().manual_seed(4)
    clone = torch.Generator().manual_seed(4)
    sampled = spatial_softmax.spatial_softmax(torch.from_numpy(features), temperature,
                                              generator=generator)
    g = spatial_softmax.draw_gumbel(clone, (2 * 3, 5 * 6), torch.float32, "cpu")
    g_nhwc = g.reshape(2, 3, 5, 6).permute(0, 2, 3, 1)
    direct = spatial_softmax.spatial_softmax(
        torch.from_numpy(features) + temperature * g_nhwc, temperature)
    for s, d in zip(sampled, direct):
        torch.testing.assert_close(s, d, rtol=TOL, atol=TOL)
    deterministic = spatial_softmax.spatial_softmax(torch.from_numpy(features), temperature)
    assert not torch.allclose(sampled[0], deterministic[0])
