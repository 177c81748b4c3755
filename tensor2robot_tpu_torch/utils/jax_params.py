"""Converts a flax params tree into the port's `state_dict`.

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
