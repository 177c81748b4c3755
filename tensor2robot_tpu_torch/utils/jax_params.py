"""Converts flax variables (and an optax Adam state) into the port's
state dicts.

The port names its modules as the flax modules are named (Conv_0, embed,
encoder.block_0.attention.qkv, grasping44.conv2.BatchNorm_0, ...), so a
params tree given as nested dicts of numpy arrays maps leaf by leaf:

  * Conv `kernel` HWIO -> `weight` OIHW; a 1-D Conv's WIO -> OIW
  * Dense `kernel` [in, out] -> Linear `weight` [out, in]
  * LayerNorm and BatchNorm `scale` -> `weight`; every `bias` as is
  * any other leaf (e.g. `pos_embedding`) as is

and a `batch_stats` tree (BatchNorm `mean`, `var`) maps onto the buffers
of the same names (layers/batch_norm.py). `load_flax_variables` loads a
whole variables dict into a network and names every key that does not
match, in either direction.

A MAML model's variables (meta_learning/maml_model.py) are
{'params': {'base': ..., 'inner_lrs': ...}, 'batch_stats': ...}: the base
tree maps under `base.` by the rules above, the base's batch_stats under
`base.` too, and each learned inner rate (a scalar at the flax path of the
base parameter it steps) onto `inner_lrs.<that path>` of the port's
MAMLNetwork. An optax Adam state over that tree maps the same way.

A pipelined encoder's flax `pipe_stages` subtree holds every stage's
blocks as [S, ...] leaves. `flax_params_to_state_dict` maps it three
ways (`pipe_stage`): stacked, each stage's slice converted and stacked
again (the trainer's checkpoint layout: `encoder.pipe_stages.block_<b>.*`
[S, ...]); one rank's stage s (`pipe_stages.block_<b>.*` of stage s,
what that pipe rank's network holds); or the chain (stage s's block b as
`block_<s * L/S + b>`, the single-device twin's layout). And
`state_dict_to_flax_params` maps a state dict back into the flax tree,
stacked stages included. `flax_dims` is the dim map of one entry: which
flax dim each of its dims holds (parallel/mesh.py decides a parameter's
sharding on the flax layout, as the JAX package does, through it).
"""

from __future__ import annotations

from collections import abc as cabc
from typing import Dict, Tuple, Union

import numpy as np
import torch

from tensor2robot_tpu_torch.parallel.mesh import PIPE_STAGES_KEY


#: rank -> the flax kernel dim that each dim of the torch weight holds:
#: weight = kernel.transpose(dims).
_KERNEL_DIMS = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def _is_maml_tree(params: cabc.Mapping) -> bool:
    return set(params) == {"base", "inner_lrs"}


def _flax_paths(node: cabc.Mapping, prefix: str = ""):
    """(the '/'-joined path, leaf) of every leaf of a nested mapping."""
    for key, value in node.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, cabc.Mapping):
            yield from _flax_paths(value, path)
        else:
            yield path, value


def _stage_slice(node: cabc.Mapping, stage: int):
    return {k: _stage_slice(v, stage) if isinstance(v, cabc.Mapping)
            else np.asarray(v)[stage] for k, v in node.items()}


def _pipe_stages_entries(stages: cabc.Mapping, prefix: str,
                         pipe_stage: Union[None, int, str]) -> Dict[str, torch.Tensor]:
    """The state entries of a flax `pipe_stages` subtree under `prefix`
    (module docstring's three layouts)."""
    count = np.asarray(next(leaf for _, leaf in _flax_paths(stages))).shape[0]
    per_stage = [flax_params_to_state_dict(_stage_slice(stages, s)) for s in range(count)]
    head = f"{prefix}.{PIPE_STAGES_KEY}" if prefix else PIPE_STAGES_KEY
    if pipe_stage is None:
        return {f"{head}.{k}": torch.stack([p[k] for p in per_stage])
                for k in per_stage[0]}
    if pipe_stage != "chain":
        return {f"{head}.{k}": v for k, v in per_stage[int(pipe_stage)].items()}
    out = {}
    for s, entries in enumerate(per_stage):
        for key, value in entries.items():
            block, rest = key.split(".", 1)
            name = f"block_{s * len(stages) + int(block[len('block_'):])}.{rest}"
            out[f"{prefix}.{name}" if prefix else name] = value
    return out


def flax_params_to_state_dict(
    params: cabc.Mapping, pipe_stage: Union[None, int, str] = None,
) -> Dict[str, torch.Tensor]:
    """`params` is the flax 'params' collection (not the variables dict
    around it), as nested mappings of numpy arrays; a MAML tree's
    `inner_lrs` map by their flax paths; a `pipe_stages` subtree maps as
    `pipe_stage` says (None: stacked, s: stage s, "chain": the chain of
    blocks; module docstring)."""
    if _is_maml_tree(params):
        state = {f"base.{k}": v
                 for k, v in flax_params_to_state_dict(params["base"]).items()}
        for path, value in _flax_paths(params["inner_lrs"]):
            state[f"inner_lrs.{path}"] = torch.tensor(np.asarray(value))
        return state
    state: Dict[str, torch.Tensor] = {}

    def walk(node: cabc.Mapping, prefix: str) -> None:
        for key, value in node.items():
            path = f"{prefix}.{key}" if prefix else key
            if key == PIPE_STAGES_KEY and isinstance(value, cabc.Mapping):
                state.update(_pipe_stages_entries(value, prefix, pipe_stage))
                continue
            if isinstance(value, cabc.Mapping):
                walk(value, path)
                continue
            array = np.asarray(value)
            name = key
            if key == "kernel":
                name = "weight"
                dims = _KERNEL_DIMS.get(array.ndim)
                if dims is None:
                    raise ValueError(
                        f"{path}: kernel of rank {array.ndim} has no torch "
                        "layout rule"
                    )
                array = array.transpose(dims)
            elif key == "scale":
                name = "weight"
            target = f"{prefix}.{name}" if prefix else name
            state[target] = torch.tensor(array)

    walk(params, "")
    return state


def _to_flax_leaf(name: str, array: np.ndarray):
    """(flax leaf name, array) of one state entry (the inverse of
    flax_params_to_state_dict's rules)."""
    if name != "weight":
        return name, array
    if array.ndim == 1:
        return "scale", array
    if array.ndim not in _KERNEL_DIMS:
        raise ValueError(f"weight of rank {array.ndim} has no flax layout rule")
    return "kernel", array.transpose(np.argsort(_KERNEL_DIMS[array.ndim]))


def flax_dims(name: str, ndim: int) -> Tuple[int, ...]:
    """The dim map of a state-dict entry (its '.'-joined name and its
    rank): entry i is the dim of the entry's flax leaf that the entry's
    dim i holds. A Linear or Conv `weight` of rank 2 to 4 is a transposed
    flax kernel ([out, in] of [in, out]; OIHW of HWIO; OIW of WIO); every
    other entry keeps the flax layout."""
    if name.rpartition(".")[2] == "weight" and ndim in _KERNEL_DIMS:
        return _KERNEL_DIMS[ndim]
    return tuple(range(ndim))


def state_dict_to_flax_params(state: cabc.Mapping) -> Dict:
    """A state dict of parameters as the flax 'params' tree of numpy
    arrays: Linear and Conv `weight` -> `kernel` (transposed), LayerNorm
    `weight` -> `scale`, every other entry as is. Entries under
    `pipe_stages` are taken as stacked ([S, ...], the trainer's checkpoint
    layout) and become the flax tree's stacked leaves."""
    tree: Dict = {}
    for key, value in state.items():
        array = (value.detach().cpu().numpy() if isinstance(value, torch.Tensor)
                 else np.asarray(value))
        *path, name = key.split(".")
        if PIPE_STAGES_KEY in path:
            pairs = [_to_flax_leaf(name, part) for part in array]
            name, array = pairs[0][0], np.stack([a for _, a in pairs])
        else:
            name, array = _to_flax_leaf(name, array)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[name] = array
    return tree


def flax_variables_to_state_dict(
    variables: cabc.Mapping,
) -> Dict[str, torch.Tensor]:
    """A flax variables dict ({'params': ..., 'batch_stats': ...}) as one
    state dict: params by flax_params_to_state_dict's rules, batch_stats
    leaves under their own names. Any other collection raises, by name."""
    unknown = sorted(set(variables) - {"params", "batch_stats"})
    if unknown:
        raise ValueError(f"no torch layout rule for the collections {unknown}")
    state = flax_params_to_state_dict(variables.get("params", {}))

    def walk(node: cabc.Mapping, prefix: str) -> None:
        for key, value in node.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(value, cabc.Mapping):
                walk(value, path)
            else:
                state[path] = torch.tensor(np.asarray(value))

    is_maml = _is_maml_tree(variables.get("params", {}))
    walk(variables.get("batch_stats", {}), "base" if is_maml else "")
    return state


def load_flax_variables(network: torch.nn.Module, variables: cabc.Mapping) -> None:
    """Loads a flax variables dict into `network` in place. Raises
    ValueError naming every converted key the network lacks, every key of
    the network's state dict that the variables lack, and every shape
    that differs; nothing is skipped."""
    state = flax_variables_to_state_dict(variables)
    own = network.state_dict()
    problems = [f"not in the network: {k}" for k in sorted(set(state) - set(own))]
    problems += [f"not in the variables: {k}" for k in sorted(set(own) - set(state))]
    problems += [
        f"shape of {k}: {tuple(state[k].shape)} vs the network's {tuple(v.shape)}"
        for k, v in own.items() if k in state and state[k].shape != v.shape
    ]
    if problems:
        raise ValueError("flax variables do not match the network:\n  "
                         + "\n  ".join(problems))
    network.load_state_dict(
        {k: v.to(own[k].dtype) for k, v in state.items()}, strict=True
    )


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
