"""Action decoders for VRGripper behavioral cloning.

Port of tensor2robot_tpu/research/vrgripper/decoders.py. A decoder is
built with its input and output widths, `Decoder(input_size,
output_size, ...)`, and called as `decoder(params, labels=None,
generator=None) -> (action, aux)`, where aux carries 'nll' (the
decoder's negative log-likelihood or loss on `labels`) when labels are
given. Modules are named as the flax modules are (pose, MDNParams_0,
maf_mus, made{i}.masked{j}, bin_logits).

MADE's masks are built [in, out] as flax's kernels are and kept
transposed beside nn.Linear-layout weights, as buffers outside the state
dict; MAF's permutations come from np.random.RandomState(seed), the
JAX package's numpy call, so both packages stack the same flows. The MAF
action inverts the flow from the base mean, or from a base sample drawn
from `generator` when one is given (the JAX package's 'sample' rng).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers import mdn as mdn_lib


class MSEDecoder(nn.Module):
    """Plain linear head + mean-squared-error loss."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.pose = nn.Linear(input_size, output_size)

    def forward(self, params, labels=None, generator=None):
        del generator
        action = self.pose(params)
        aux = {}
        if labels is not None:
            aux["nll"] = torch.mean(torch.square(action - labels))
        return action, aux


class MDNDecoder(nn.Module):
    """Gaussian-mixture head: action = approximate mode, loss = mixture
    NLL."""

    def __init__(self, input_size: int, output_size: int,
                 num_mixture_components: int = 1, condition_sigmas: bool = False):
        super().__init__()
        self.output_size = output_size
        self.num_mixture_components = num_mixture_components
        self.MDNParams_0 = mdn_lib.MDNParams(input_size, num_mixture_components,
                                             output_size, condition_sigmas)

    def forward(self, params, labels=None, generator=None):
        del generator
        dist_params = self.MDNParams_0(params)
        gm = mdn_lib.get_mixture_distribution(dist_params, self.num_mixture_components,
                                              self.output_size)
        aux = {"dist_params": dist_params}
        if labels is not None:
            aux["nll"] = mdn_lib.mdn_loss(gm, labels)
        return gm.approximate_mode(), aux


class MaskedDense(nn.Linear):
    """Dense layer with a fixed 0/1 connectivity mask (the MADE building
    block, Germain et al. arXiv:1502.03509); `mask` is [in, out]."""

    def __init__(self, in_features: int, features: int, mask: np.ndarray):
        super().__init__(in_features, features)
        self.register_buffer("mask", torch.as_tensor(np.asarray(mask).T, dtype=torch.float32),
                             persistent=False)

    def flax_init(self, generator: torch.Generator) -> None:
        """glorot_uniform kernel, zero bias."""
        limit = math.sqrt(6.0 / (self.weight.shape[0] + self.weight.shape[1]))
        with torch.no_grad():
            nn.init.uniform_(self.weight, -limit, limit, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight * self.mask.to(self.weight.dtype), self.bias)


def _made_masks(event_size: int, hidden_layers: Sequence[int]) -> Tuple[list, np.ndarray]:
    """MADE degree masks [in, out]: hidden degrees cycle 1..D-1; output i
    depends only on inputs < i."""
    degrees = [np.arange(1, event_size + 1)]
    for width in hidden_layers:
        degrees.append((np.arange(width) % max(1, event_size - 1)) + 1)
    masks = [(previous[:, None] <= current[None, :]).astype(np.float32)
             for previous, current in zip(degrees[:-1], degrees[1:])]
    out_mask = (degrees[-1][:, None] < degrees[0][None, :]).astype(np.float32)
    return masks, out_mask


class MADE(nn.Module):
    """Masked autoregressive conditioner: x -> (shift, log_scale), each
    output dim depending only on strictly earlier input dims."""

    def __init__(self, event_size: int, hidden_layers: Sequence[int] = (64, 64)):
        super().__init__()
        masks, out_mask = _made_masks(event_size, hidden_layers)
        self.num_hidden = len(hidden_layers)
        width = event_size
        for i, (hidden, mask) in enumerate(zip(hidden_layers, masks)):
            self.add_module(f"masked{i}", MaskedDense(width, hidden, mask))
            width = hidden
        self.masked_out = MaskedDense(width, 2 * event_size,
                                      np.concatenate([out_mask, out_mask], axis=1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        net = x
        for i in range(self.num_hidden):
            net = F.relu(getattr(self, f"masked{i}")(net))
        shift, log_scale = torch.chunk(self.masked_out(net), 2, dim=-1)
        return shift, 5.0 * torch.tanh(log_scale / 5.0)


class MAFDecoder(nn.Module):
    """Masked autoregressive flow over the conditioned base N(mu(params),
    1), flows chained with fixed permutations. Loss = mean NLL of labels."""

    def __init__(self, input_size: int, output_size: int, num_flows: int = 1,
                 hidden_layers: Sequence[int] = (64, 64), permutation_seed: int = 42):
        super().__init__()
        if any(output_size > width for width in hidden_layers):
            raise ValueError("MAF hidden layers have to be at least as wide as event size.")
        self.num_flows = num_flows
        self.maf_mus = nn.Linear(input_size, output_size)
        for i in range(num_flows):
            self.add_module(f"made{i}", MADE(output_size, hidden_layers))
        rng = np.random.RandomState(permutation_seed)
        self.perms = [rng.permutation(output_size) for _ in range(num_flows - 1)]

    def _flow(self, i: int) -> MADE:
        return getattr(self, f"made{i}")

    def log_prob(self, x: torch.Tensor, mus: torch.Tensor) -> torch.Tensor:
        """Density direction: one MADE pass per flow."""
        log_det = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for i in reversed(range(self.num_flows)):
            shift, log_scale = self._flow(i)(x)
            x = (x - shift) * torch.exp(-log_scale)
            log_det = log_det - log_scale.sum(dim=-1)
            if i > 0:
                x = x[..., np.argsort(self.perms[i - 1])]
        base = -0.5 * torch.sum(torch.square(x - mus) + math.log(2.0 * math.pi), dim=-1)
        return base + log_det

    def sample_direction(self, u: torch.Tensor) -> torch.Tensor:
        """Autoregressive inversion, one MADE pass per event dim."""
        x = u
        columns = torch.arange(u.shape[-1], device=u.device)
        for i in range(self.num_flows):
            if i > 0:
                x = x[..., self.perms[i - 1]]
            y = torch.zeros_like(x)
            for d in range(u.shape[-1]):
                shift, log_scale = self._flow(i)(y)
                value = x[..., d] * torch.exp(log_scale[..., d]) + shift[..., d]
                y = torch.where(columns == d, value[..., None], y)
            x = y
        return x

    def forward(self, params, labels=None, generator=None):
        mus = self.maf_mus(params)
        base = mus
        if generator is not None:
            base = mus + torch.randn(mus.shape, generator=generator, dtype=mus.dtype,
                                     device=mus.device)
        aux = {}
        if labels is not None:
            aux["nll"] = -torch.mean(self.log_prob(labels, mus))
        return self.sample_direction(base), aux


def get_discrete_bins(num_bins: int, output_min: np.ndarray,
                      output_max: np.ndarray) -> np.ndarray:
    """Bin centers discretizing [output_min, output_max] per action dim:
    [num_bins, action_dim]."""
    bin_sizes = (np.asarray(output_max) - np.asarray(output_min)) / float(num_bins)
    return np.array([np.asarray(output_min) + bin_sizes * (i + 0.5)
                     for i in range(num_bins)])


def get_discrete_actions(logits: torch.Tensor, action_size: int, num_bins: int,
                         bin_centers: np.ndarray) -> torch.Tensor:
    """Mode of each dim's categorical -> its bin center."""
    probabilities = torch.softmax(logits.reshape(-1, action_size, num_bins), dim=-1)
    one_hot = F.one_hot(torch.argmax(probabilities, dim=-1), num_bins).to(logits.dtype)
    centers = torch.as_tensor(bin_centers.T, dtype=logits.dtype, device=logits.device)
    actions = torch.sum(one_hot * centers, dim=-1)
    return actions.reshape(tuple(logits.shape[:-1]) + (action_size,))


def get_discrete_action_loss(logits: torch.Tensor, action_labels: torch.Tensor,
                             bin_centers: np.ndarray, num_bins: int) -> torch.Tensor:
    """Nearest-bin one-hot labels -> softmax cross-entropy."""
    centers = torch.as_tensor(bin_centers, dtype=action_labels.dtype,
                              device=action_labels.device)
    distance = torch.square(action_labels[..., None, :] - centers)
    discrete_labels = torch.argmin(distance, dim=-2)
    one_hot = F.one_hot(discrete_labels, num_bins).reshape(-1, num_bins).to(logits.dtype)
    log_probs = F.log_softmax(logits.reshape(-1, num_bins), dim=-1)
    return -torch.mean(torch.sum(one_hot * log_probs, dim=-1))


class DiscreteDecoder(nn.Module):
    """Per-dim categorical head over discretized action bins."""

    def __init__(self, input_size: int, output_size: int, num_bins: int = 11,
                 action_low: float = -1.0, action_high: float = 1.0):
        super().__init__()
        self.output_size = output_size
        self.num_bins = num_bins
        self.bin_logits = nn.Linear(input_size, output_size * num_bins)
        self.bin_centers = get_discrete_bins(num_bins, np.full((output_size,), action_low),
                                             np.full((output_size,), action_high))

    def forward(self, params, labels=None, generator=None):
        del generator
        logits = self.bin_logits(params)
        action = get_discrete_actions(logits, self.output_size, self.num_bins,
                                      self.bin_centers)
        aux = {"bin_logits": logits}
        if labels is not None:
            aux["nll"] = get_discrete_action_loss(
                logits.reshape(tuple(labels.shape[:-1])
                               + (self.output_size * self.num_bins,)),
                labels, self.bin_centers, self.num_bins)
        return action, aux
