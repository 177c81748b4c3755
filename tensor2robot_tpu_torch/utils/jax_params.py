"""Converts a flax params tree (and an optax Adam state) into the port's
state dicts.

The port names its modules as the flax modules are named (Conv_0, embed,
encoder.block_0.attention.qkv, ...), so a params tree given as nested
dicts of numpy arrays maps leaf by leaf:

  * Conv `kernel` HWIO -> `weight` OIHW
  * Dense `kernel` [in, out] -> Linear `weight` [out, in]
  * LayerNorm `scale` -> `weight`; every `bias` as is
  * any other leaf (e.g. `pos_embedding`) as is
"""

from __future__ import annotations

from collections import abc as cabc
from typing import Dict

import numpy as np
import torch


def flax_params_to_state_dict(params: cabc.Mapping) -> Dict[str, torch.Tensor]:
    """`params` is the flax 'params' collection (not the variables dict
    around it), as nested mappings of numpy arrays."""
    state: Dict[str, torch.Tensor] = {}

    def walk(node: cabc.Mapping, prefix: str) -> None:
        for key, value in node.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(value, cabc.Mapping):
                walk(value, path)
                continue
            array = np.asarray(value)
            name = key
            if key == "kernel":
                name = "weight"
                if array.ndim == 2:
                    array = array.T
                elif array.ndim == 4:
                    array = array.transpose(3, 2, 0, 1)
                else:
                    raise ValueError(
                        f"{path}: kernel of rank {array.ndim} has no torch "
                        "layout rule"
                    )
            elif key == "scale":
                name = "weight"
            target = f"{prefix}.{name}" if prefix else name
            state[target] = torch.tensor(array)

    walk(params, "")
    return state


def optax_adam_state_to_optimizer_state(
    mu: cabc.Mapping,
    nu: cabc.Mapping,
    count: int,
    optimizer: torch.optim.Optimizer,
    network: torch.nn.Module,
) -> Dict:
    """The optax Adam state (the `mu` and `nu` trees of ScaleByAdamState,
    laid out like the params, and its update `count`) as a state dict for
    `optimizer`, the port's Adam bound to `network`'s parameters
    (models/optimizers.py): mu -> exp_avg, nu -> exp_avg_sq, count ->
    each parameter's step and the param groups' schedule count. The moment
    trees map leaf by leaf under the same layout rules as the params."""
    moments = flax_params_to_state_dict(mu), flax_params_to_state_dict(nu)
    index = {
        id(p): i
        for i, p in enumerate(
            p for group in optimizer.param_groups for p in group["params"]
        )
    }
    state = optimizer.state_dict()
    state["state"] = {
        index[id(p)]: {
            "step": torch.tensor(float(count)),
            "exp_avg": moments[0][name].to(p.dtype),
            "exp_avg_sq": moments[1][name].to(p.dtype),
        }
        for name, p in network.named_parameters()
    }
    for group in state["param_groups"]:
        group["count"] = int(count)
    return state
