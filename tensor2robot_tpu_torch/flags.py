"""Registry of the `T2R_*` environment gates the port reads.

Every flag is declared once (name, kind, default, doc, owning module) and
every read goes through a typed getter that parses and validates the same
way everywhere, failing fast with the flag name in the message. Names,
defaults and parsing match tensor2robot_tpu/flags.py, so one environment
configures both packages alike; only the gates of the ported modules
(the policy server, the trainer's infeed, the max pool's backward and the
Grasping44 stem) are declared here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

__all__ = [
    "FlagSpec",
    "all_flags",
    "get_flag",
    "get_int",
    "get_enum",
    "get_str",
]

_INT, _ENUM, _STR = "int", "enum", "str"


@dataclasses.dataclass(frozen=True)
class FlagSpec:
    """One declared env gate.

    Attributes:
      name: The full environment variable name (T2R_...).
      kind: 'int', 'enum' (one of `choices`), or 'str'.
      default: The value returned when the variable is unset.
      doc: One-line description of what the gate controls.
      owner: The module that consumes the flag.
      choices: Accepted values for 'enum' flags.
      minimum: Lower clamp for 'int' flags.
    """

    name: str
    kind: str
    default: object
    doc: str
    owner: str
    choices: Optional[Tuple[str, ...]] = None
    minimum: Optional[int] = None


_REGISTRY: Dict[str, FlagSpec] = {}
_SERVER = "tensor2robot_tpu_torch/serving/server.py"


def _declare(name, kind, default, doc, owner, choices=None, minimum=None):
    if name in _REGISTRY:
        raise ValueError(f"flag {name} declared twice")
    if not name.startswith("T2R_"):
        raise ValueError(f"flag {name} must be namespaced T2R_*")
    if kind == _ENUM and not choices:
        raise ValueError(f"enum flag {name} needs choices")
    _REGISTRY[name] = FlagSpec(name, kind, default, doc, owner, choices, minimum)


_declare(
    "T2R_INFEED_DEPTH",
    _INT,
    2,
    "Device-prefetch depth: batches kept in flight ahead of the consumer.",
    "tensor2robot_tpu_torch/train/infeed.py",
    minimum=1,
)
_declare(
    "T2R_POOL_BACKWARD",
    _ENUM,
    "auto",
    "Max-pool backward: native routes a tied window's gradient to one "
    "element (max_pool2d's), auto and scatterfree split it equally.",
    "tensor2robot_tpu_torch/ops/pooling.py",
    choices=("auto", "native", "scatterfree"),
)
_declare(
    "T2R_SERVE_BUCKETS",
    _STR,
    None,
    "Comma-separated batch-size bucket ladder for the policy server when "
    "the constructor passes none (unset = (1,)).",
    "tensor2robot_tpu_torch/serving/buckets.py",
)
_declare(
    "T2R_SERVE_DEADLINE_MS",
    _INT,
    1000,
    "Default per-request deadline (ms) when submit() passes none.",
    _SERVER,
    minimum=1,
)
_declare(
    "T2R_SERVE_MAX_QUEUE",
    _INT,
    256,
    "Policy-server admission bound: max queued requests before the "
    "overload policy engages.",
    _SERVER,
    minimum=1,
)
_declare(
    "T2R_SERVE_MAX_WAIT_MS",
    _INT,
    5,
    "Micro-batcher coalesce window (ms) from first queued request to "
    "dispatch.",
    _SERVER,
    minimum=0,
)
_declare(
    "T2R_SERVE_OVERLOAD",
    _ENUM,
    "shed_oldest",
    "Full-queue policy: shed_oldest fails the oldest queued request, "
    "reject refuses the incoming one.",
    _SERVER,
    choices=("shed_oldest", "reject"),
)
_declare(
    "T2R_SERVE_PREDICT_TIMEOUT_MS",
    _INT,
    0,
    "Per-batch predictor compute watchdog (ms): a predict call exceeding "
    "it fails that batch's futures with PredictTimeout and the dispatcher "
    "keeps serving. 0 = no watchdog (predict runs on the dispatcher "
    "thread).",
    _SERVER,
    minimum=0,
)

_declare(
    "T2R_STEM_S2D",
    _ENUM,
    "auto",
    "Space-to-depth lowering of the Grasping44 stem; auto resolves off, "
    "and 1 is not ported.",
    "tensor2robot_tpu_torch/research/qtopt/networks.py",
    choices=("auto", "0", "1"),
)


def all_flags() -> Tuple[FlagSpec, ...]:
    return tuple(_REGISTRY[name] for name in sorted(_REGISTRY))


def get_flag(name: str) -> FlagSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(
            f"{name} is not a declared T2R flag; declare it in "
            "tensor2robot_tpu_torch/flags.py"
        )
    return spec


def _raw(spec: FlagSpec) -> Optional[str]:
    return os.environ.get(spec.name)


def get_int(name: str) -> int:
    spec = get_flag(name)
    if spec.kind != _INT:
        raise TypeError(f"{name} is a {spec.kind} flag, not int")
    raw = _raw(spec)
    if raw is None:
        value = int(spec.default)
    else:
        try:
            value = int(raw)
        except ValueError as err:
            raise ValueError(
                f"{name} must be an integer, got {raw!r}"
            ) from err
    if spec.minimum is not None:
        value = max(spec.minimum, value)
    return value


def get_enum(name: str) -> str:
    spec = get_flag(name)
    if spec.kind != _ENUM:
        raise TypeError(f"{name} is a {spec.kind} flag, not enum")
    raw = _raw(spec)
    if raw is None:
        return str(spec.default)
    if raw not in spec.choices:
        raise ValueError(f"{name}={raw!r}: expected {'|'.join(spec.choices)}")
    return raw


def get_str(name: str) -> Optional[str]:
    spec = get_flag(name)
    if spec.kind != _STR:
        raise TypeError(f"{name} is a {spec.kind} flag, not str")
    raw = _raw(spec)
    return spec.default if raw is None else raw
