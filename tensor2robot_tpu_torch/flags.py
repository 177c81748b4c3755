"""Registry of the `T2R_*` environment gates the port reads.

Every flag is declared once (name, kind, default, doc, owning module) and
every read goes through a typed getter that parses and validates the same
way everywhere, failing fast with the flag name in the message. Names,
defaults and parsing match tensor2robot_tpu/flags.py, so one environment
configures both packages alike; only the gates of the ported modules
(the policy server, the trainer's infeed, the data stack, the max pool's
backward, the Grasping44 stem, the ZeRO-2 gradient codecs, the sharding
planner with its plan cache, the low-precision serving regimes, the AOT
serving packages with their compile-cache tier and the artifact store) are
declared here. One default differs from the JAX package's:
T2R_AOT_EXPORT is 0 here (its help text says why).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

__all__ = [
    "FlagSpec",
    "all_flags",
    "get_bool",
    "get_flag",
    "get_int",
    "get_optional_int",
    "get_enum",
    "get_str",
]

_BOOL, _INT, _ENUM, _STR = "bool", "int", "enum", "str"


@dataclasses.dataclass(frozen=True)
class FlagSpec:
    """One declared env gate.

    Attributes:
      name: The full environment variable name (T2R_...).
      kind: 'bool' ('0' or '1'), 'int', 'enum' (one of `choices`), or
        'str'.
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
_DATASET = "tensor2robot_tpu_torch/data/dataset.py"
_COLLECTIVES = "tensor2robot_tpu_torch/parallel/collectives.py"


def _declare(name, kind, default, doc, owner, choices=None, minimum=None):
    if name in _REGISTRY:
        raise ValueError(f"flag {name} declared twice")
    if not name.startswith("T2R_"):
        raise ValueError(f"flag {name} must be namespaced T2R_*")
    if kind == _ENUM and not choices:
        raise ValueError(f"enum flag {name} needs choices")
    _REGISTRY[name] = FlagSpec(name, kind, default, doc, owner, choices, minimum)


_SAVED_MODEL = "tensor2robot_tpu_torch/export/saved_model.py"
_STORE = "tensor2robot_tpu_torch/export/artifact_store.py"
_declare(
    "T2R_AOT_EXPORT",
    _BOOL,
    False,
    "Export-side AOT packages: compile one AOTInductor package per "
    "warmup bucket (per serve-quant regime too) into the export dir's "
    "aot/, keyed on artifact fingerprint + device topology "
    "(export/aot.py). 0 writes artifacts without aot/ (the pre-AOT "
    "layout). The default is 0, where the JAX package's is 1: an "
    "AOTInductor build takes tens of seconds a bucket, so every exporter "
    "with a warmup ladder would pay it; aot_executables=True on the "
    "exporter, or this flag set to 1, builds the packages.",
    _SAVED_MODEL,
)
_declare(
    "T2R_AOT_REQUIRE",
    _BOOL,
    False,
    "Strict AOT boots: a restore that cannot load an AOT package for "
    "EVERY warmup bucket fails loudly instead of falling back to the "
    "compile tiers — for fleets where a deploy-time compile is an SLO "
    "violation, not a slow path.",
    _SAVED_MODEL,
)
_declare(
    "T2R_COLLECTIVE_BLOCK",
    _INT,
    512,
    "Quantization block size (elements per scale) for quantized gradient "
    "collectives.",
    _COLLECTIVES,
    minimum=1,
)
_declare(
    "T2R_COLLECTIVE_QUANT",
    _ENUM,
    "none",
    "Gradient-collective wire format of the ZeRO-2 data-parallel step; "
    "none keeps the exact reduce-scatter and all-gather. fp16, int8 and "
    "the fp8 formats send block-scaled values with an error-feedback "
    "residual.",
    _COLLECTIVES,
    choices=("none", "fp16", "int8", "fp8_e4m3", "fp8_e5m2"),
)
_declare(
    "T2R_COMPILE_CACHE_DIR",
    _STR,
    None,
    "Persistent compile-cache directory for serving processes "
    "(serving/compile_cache.py): Inductor's and Triton's on-disk caches "
    "point there, so a second build of the same program on the host "
    "reads its kernels from disk. Unset = no persistent cache.",
    "tensor2robot_tpu_torch/serving/compile_cache.py",
)
_declare(
    "T2R_DECODE_CACHE_MB",
    _INT,
    512,
    "Decoded-image cache byte budget in MB; 0 disables the cache.",
    "tensor2robot_tpu_torch/data/wire.py",
    minimum=0,
)
_declare(
    "T2R_DECODE_ROI",
    _BOOL,
    True,
    "Honor decode-time ROI crops; 0 restores full-frame decode exactly.",
    _DATASET,
)
_declare(
    "T2R_INFEED_DEPTH",
    _INT,
    2,
    "Device-prefetch depth: batches kept in flight ahead of the consumer.",
    "tensor2robot_tpu_torch/train/infeed.py",
    minimum=1,
)
_declare(
    "T2R_MULTI_EVAL_NAME",
    _STR,
    None,
    "Selects the eval dataset for MultiEvalRecordInputGenerator.",
    "tensor2robot_tpu_torch/data/input_generators.py",
)
_declare(
    "T2R_PARSE_BACKEND",
    _ENUM,
    "thread",
    "Parse worker pool backend.",
    _DATASET,
    choices=("thread", "process"),
)
_declare(
    "T2R_PARSE_FAST",
    _BOOL,
    True,
    "Wire-format fast parser (SpecParser stays the per-batch fallback).",
    _DATASET,
)
_declare(
    "T2R_PARSE_ON_ERROR",
    _ENUM,
    "raise",
    "Data-pipeline behavior on a corrupt record (both the fast parser and "
    "the SpecParser oracle refuse it): raise kills the consumer with the "
    "oracle's error; skip drops the bad record(s), counts them in the "
    "dataset's stats()['records_skipped'] and yields the surviving batch.",
    _DATASET,
    choices=("raise", "skip"),
)
_declare(
    "T2R_PARSE_SHM",
    _BOOL,
    True,
    "Process-backend batches return via the shared-memory ring.",
    _DATASET,
)
_declare(
    "T2R_PARSE_WORKERS",
    _INT,
    None,
    "Parse pool size; 0 = synchronous; unset = min(8, cpu_count).",
    _DATASET,
    minimum=0,
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
_SERVE_QUANT = "tensor2robot_tpu_torch/export/serve_quant.py"
_declare(
    "T2R_SERVE_CALIB",
    _ENUM,
    "static",
    "Activation-calibration mode for NATIVE low-precision serving "
    "exports (export/serve_quant.py): 'static' (default) bakes "
    "export-time per-layer 99.9th-percentile activation clips into the "
    "serving program as constants — zero per-dispatch activation-quant "
    "reductions (audit_quant_reduces), with per-layer demotion back to "
    "dynamic when the warmup overshoot exceeds the gate; 'dynamic' "
    "keeps the per-row max-abs quant op for op (conv/attention lowering "
    "is map-driven, not calib-driven: disable it via "
    "T2R_SERVE_NATIVE_LAYERS/T2R_SERVE_NATIVE_ATTN).",
    _SERVE_QUANT,
    choices=("static", "dynamic"),
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
    "T2R_SERVE_NATIVE_ATTN",
    _STR,
    None,
    "Attention-head eligibility for NATIVE low-precision QK^T/PV "
    "contractions in quantized serving exports (export/serve_quant.py): "
    "unset or 'auto' = every attention module on the materialized-"
    "logits einsum path quantizes both contraction operands (per-row "
    "or static scales on the accumulator; flash/ring/ulysses heads "
    "never lower); 'none' = attention stays on the f32 einsum path; "
    "anything else = comma-separated fnmatch globs over attention "
    "module paths selecting WHICH heads lower.",
    _SERVE_QUANT,
)
_declare(
    "T2R_SERVE_NATIVE_LAYERS",
    _STR,
    None,
    "Per-layer eligibility override for NATIVE low-precision matmuls in "
    "quantized serving exports (export/serve_quant.py): unset or 'auto' "
    "= the default map (dense and conv '.../kernel' leaves contract on "
    "int8/fp8 operands with the scales applied to the accumulator); "
    "'none' = disable native lowering (every layer dequantizes before "
    "the matmul); anything else = comma-separated fnmatch globs over "
    "flat param paths selecting WHICH structurally-eligible layers "
    "lower natively (parity-fragile layers stay on the dequant path).",
    _SERVE_QUANT,
)
_declare(
    "T2R_SERVE_QUANT",
    _ENUM,
    "none",
    "Low-precision serving regime for exported-artifact predictors: "
    "fp16/int8/fp8_e4m3/fp8_e5m2 serve the export's blockwise-scaled "
    "quantized payload (export/serve_quant.py) with the dequant inside "
    "the regime's serving program — and, for int8/fp8 regimes, eligible "
    "dense and conv contractions executed NATIVELY on the quantized "
    "operands (T2R_SERVE_NATIVE_LAYERS); none is the unquantized "
    "serving path byte for byte.",
    "tensor2robot_tpu_torch/export/saved_model.py",
    choices=("none", "fp16", "int8", "fp8_e4m3", "fp8_e5m2"),
)

_declare(
    "T2R_SERVE_AOT",
    _BOOL,
    True,
    "Restore-side AOT packages: serve each warmup bucket from the "
    "artifact's aot/ dir (load instead of running the eager program) "
    "with a LOUD, counted fallback to the exported program on any key "
    "mismatch. 0 reproduces the pre-AOT restore path.",
    _SAVED_MODEL,
)
_declare(
    "T2R_POLICY_DELTA_BLOCK",
    _INT,
    512,
    "Quantization block size (elements per scale) for delta-compressed "
    "sibling payloads in the content-addressed artifact store "
    "(export/artifact_store.py); each leaf's diff-vs-base is raveled "
    "and zero-padded to a block multiple before encoding.",
    _STORE,
    minimum=1,
)
_declare(
    "T2R_POLICY_DELTA_QUANT",
    _ENUM,
    "int8",
    "Wire regime for delta-compressed sibling payloads in the artifact "
    "store (export/artifact_store.py): per-leaf weight diffs vs the "
    "named base artifact encode through the blockwise collective codec "
    "(parallel/collectives.py). 'none' stores the diff dense-exact "
    "(dedup still applies to program/AOT blobs).",
    _STORE,
    choices=("none", "fp16", "int8", "fp8_e4m3", "fp8_e5m2"),
)
_declare(
    "T2R_POLICY_DELTA_TOL",
    _STR,
    "0.05",
    "Per-leaf parity-gate tolerance for delta payloads "
    "(export/artifact_store.py), parsed as a float: decode(delta)+base "
    "must reconstruct the leaf within this relative L-inf bound or THAT "
    "LEAF ships dense-exact (gate-fails-write-nothing — demotion is "
    "per leaf and recorded in the manifest, never a partial policy).",
    _STORE,
)

_PLANNER = "tensor2robot_tpu_torch/parallel/planner.py"
_declare(
    "T2R_PLAN",
    _STR,
    "off",
    "Sharding-planner gate (parallel/planner.py): 'off' (default) keeps "
    "the trainer's explicit arguments; a preset name (e.g. dp_zero2_int8, "
    "dp_sp_pp; planner.preset_names()) drives the trainer from that plan "
    "with an entry-by-entry layout audit; 'auto' enumerates DP x SP x PP x "
    "TP factorizations of the world's ranks and picks the winner (memory "
    "fit first, then estimated wire bytes).",
    _PLANNER,
)
_declare(
    "T2R_PLAN_CACHE_DIR",
    _STR,
    None,
    "Persistent plan-cache directory for T2R_PLAN=auto "
    "(parallel/plan_cache.py): the search's winning plan and measured "
    "table are stored keyed on (model fingerprint, topology, torch "
    "version, planner schema); a later auto run on the same key reads "
    "the winner and probes nothing. Rank 0 reads and writes it. Unset "
    "(the default) disables the cache: every auto run searches afresh.",
    "tensor2robot_tpu_torch/parallel/plan_cache.py",
)
_declare(
    "T2R_PLAN_MEASURE",
    _STR,
    "off",
    "Measured tier of the T2R_PLAN=auto search (parallel/planner.py): "
    "'off' (default) ranks analytically only; 'shortlist-N' builds the "
    "top N analytic candidates' trainers on every rank, times synced "
    "train steps (the slowest rank's), reads the peak device memory, "
    "and re-ranks on measured step time with memory fit as a hard gate.",
    _PLANNER,
)
_declare(
    "T2R_PLAN_MEASURE_STEPS",
    _INT,
    3,
    "Timed post-warmup train steps per shortlisted candidate in the "
    "measured plan search (the probe reports their median).",
    _PLANNER,
    minimum=1,
)
_declare(
    "T2R_PLAN_MEM_BUDGET",
    _INT,
    0,
    "Per-device memory budget in MB for T2R_PLAN=auto's factorization "
    "search; candidates whose analytic estimate exceeds it are rejected "
    "(with the estimate in the error when nothing fits). 0 = unbounded.",
    _PLANNER,
    minimum=0,
)

_declare(
    "T2R_STEM_S2D",
    _ENUM,
    "auto",
    "Space-to-depth lowering of the Grasping44 stem: 1 on, 0 off, auto "
    "resolves off.",
    "tensor2robot_tpu_torch/layers/s2d_conv.py",
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
        if spec.default is None:
            raise ValueError(f"{name} has no default; use get_optional_int")
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


def get_optional_int(name: str) -> Optional[int]:
    """An int flag whose unset state means "the caller's default"."""
    spec = get_flag(name)
    if spec.kind != _INT:
        raise TypeError(f"{name} is a {spec.kind} flag, not int")
    if _raw(spec) is None:
        return None
    return get_int(name)


def get_bool(name: str) -> bool:
    """A '0'/'1' flag; anything else fails fast with the flag name."""
    spec = get_flag(name)
    if spec.kind != _BOOL:
        raise TypeError(f"{name} is a {spec.kind} flag, not bool")
    raw = _raw(spec)
    if raw is None:
        return bool(spec.default)
    if raw not in ("0", "1"):
        raise ValueError(f"{name} must be '0' or '1', got {raw!r}")
    return raw == "1"


def write_env(name: str, value) -> None:
    """Sets a declared int flag in this process's environment (a parse
    process's share of a budget), validated at the write site."""
    spec = get_flag(name)
    if spec.kind != _INT:
        raise TypeError(f"{name} is a {spec.kind} flag, not int")
    os.environ[spec.name] = str(int(value))


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
