"""Mixture-density network head: isotropic Gaussian mixtures.

Port of tensor2robot_tpu/layers/mdn.py. The mixture is an explicit
object (`GaussianMixture`) with log_prob / approximate_mode / mean /
sample; sample draws from an explicit torch.Generator (JAX's categorical
and normal streams cannot be reproduced in torch, so the samplers are
held statistically and the deterministic parts against JAX). Parameters
are packed as in the JAX package: [alphas | mus | pre-softplus sigmas],
num_alphas + 2 * num_alphas * sample_size wide. MDNParams' Dense is
`mdn_params` and its unconditioned sigma parameter `mdn_stddev_inputs`,
as the flax names are.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MIN_SIGMA = 1e-4


@dataclasses.dataclass(frozen=True)
class GaussianMixture:
    """Mixture of isotropic Gaussians: logits [..., K], mus and sigmas
    [..., K, D] (sigmas already softplus'd and floored)."""

    logits: torch.Tensor
    mus: torch.Tensor
    sigmas: torch.Tensor

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """log p(x) for x of shape [..., D]."""
        x = x[..., None, :]
        component_logp = torch.sum(
            -0.5 * torch.square((x - self.mus) / self.sigmas)
            - torch.log(self.sigmas) - 0.5 * math.log(2.0 * math.pi), dim=-1)
        mix_logp = F.log_softmax(self.logits, dim=-1)
        return torch.logsumexp(mix_logp + component_logp, dim=-1)

    def _component(self, values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        index = index[..., None, None].expand(index.shape + (1, values.shape[-1]))
        return torch.take_along_dim(values, index, dim=-2).squeeze(-2)

    def approximate_mode(self) -> torch.Tensor:
        """Mean of the most probable component (first on ties)."""
        return self._component(self.mus, torch.argmax(self.logits, dim=-1))

    def mean(self) -> torch.Tensor:
        weights = torch.softmax(self.logits, dim=-1)
        return torch.sum(weights[..., None] * self.mus, dim=-2)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """A component drawn from the mixture weights, then a normal draw
        around its mean, both from `generator`."""
        probs = torch.softmax(self.logits.float(), dim=-1)
        component = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                      generator=generator).reshape(probs.shape[:-1])
        mu = self._component(self.mus, component)
        sigma = self._component(self.sigmas, component)
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
        return mu + sigma * eps


def get_mixture_distribution(params: torch.Tensor, num_alphas: int, sample_size: int,
                             output_mean: Optional[torch.Tensor] = None,
                             min_sigma: float = MIN_SIGMA) -> GaussianMixture:
    """Unpacks a params tensor into a GaussianMixture."""
    num_mus = num_alphas * sample_size
    if params.shape[-1] != num_alphas + 2 * num_mus:
        raise ValueError(f"Params has unexpected size {params.shape[-1]}.")
    batch_dims = tuple(params.shape[:-1])
    alphas = params[..., :num_alphas]
    mus = params[..., num_alphas:num_alphas + num_mus].reshape(
        batch_dims + (num_alphas, sample_size))
    pre_sigmas = params[..., num_alphas + num_mus:].reshape(
        batch_dims + (num_alphas, sample_size))
    if output_mean is not None:
        mus = mus + output_mean
    sigmas = F.softplus(pre_sigmas) + min_sigma
    return GaussianMixture(logits=alphas, mus=mus, sigmas=sigmas)


class MDNParams(nn.Module):
    """Projects features to MDN parameters over any leading batch dims.
    Without condition_sigmas the sigmas are a learned per-dimension
    vector, initialized so that softplus(sigma) == 1."""

    def __init__(self, input_size: int, num_alphas: int, sample_size: int,
                 condition_sigmas: bool = False):
        super().__init__()
        self.num_mus = num_alphas * sample_size
        self.condition_sigmas = condition_sigmas
        num_outputs = num_alphas + self.num_mus * (2 if condition_sigmas else 1)
        self.mdn_params = nn.Linear(input_size, num_outputs)
        if not condition_sigmas:
            self.mdn_stddev_inputs = nn.Parameter(torch.empty(self.num_mus))
            self.init_own_parameters()

    def init_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        del generator
        if not self.condition_sigmas:
            with torch.no_grad():
                self.mdn_stddev_inputs.fill_(math.log(math.e - 1.0))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        dist_params = self.mdn_params(inputs)
        if not self.condition_sigmas:
            tiled = self.mdn_stddev_inputs.to(dist_params.dtype).expand(
                dist_params.shape[:-1] + (self.num_mus,))
            dist_params = torch.cat([dist_params, tiled], dim=-1)
        return dist_params


class MDNDecoder(nn.Module):
    """Action decoder emitting the approximate mode of a Gaussian mixture.
    Returns (action, mixture); the caller computes
    `mdn_loss(mixture, labels)`."""

    def __init__(self, input_size: int, output_size: int,
                 num_mixture_components: int = 1):
        super().__init__()
        self.output_size = output_size
        self.num_mixture_components = num_mixture_components
        self.MDNParams_0 = MDNParams(input_size, num_mixture_components, output_size)

    def forward(self, params: torch.Tensor) -> Tuple[torch.Tensor, GaussianMixture]:
        gm = get_mixture_distribution(self.MDNParams_0(params),
                                      self.num_mixture_components, self.output_size)
        return gm.approximate_mode(), gm


def mdn_loss(gm: GaussianMixture, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over all batch and sequence dims."""
    return -torch.mean(gm.log_prob(targets))
