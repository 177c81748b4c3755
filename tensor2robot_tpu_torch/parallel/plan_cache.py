"""Persistent cache for the sharding planner's search results.

Port of tensor2robot_tpu/parallel/plan_cache.py. The measured tier of the
planner (parallel/planner.py, T2R_PLAN=auto with T2R_PLAN_MEASURE) pays
real train steps on every rank to rank its shortlist: work that changes
only when the model, the topology, or the planner itself changes. This
module remembers the winner: the second auto run on a known (model,
topology) pair probes nothing, it reads the plan the first run measured.
Rank 0 alone reads and writes the cache (planner._auto_search broadcasts
what it read or chose), so the ranks of a world never disagree.

Cache key, all-or-nothing (any component differing is a miss):

  * model-spec fingerprint: sha256 over every parameter's, optimizer
    state entry's and batch feature's (name, flax shape, dtype) and the
    spec's geometry fields;
  * topology (`device_topology`): platform, device name, compute
    capability (sm_90 on an H100) and world size, where JAX keys on its
    export/aot.py device topology;
  * the torch version, where JAX keys on its jax version: measured step
    times are not stable across runtimes;
  * the planner schema version (PLAN_CACHE_FORMAT_VERSION), bumped when
    the search space or ShardingPlan schema changes, so a winner from a
    narrower search never shadows a wider one.

Envelope (one file per fingerprint, `plan_<fp>.bin` under
T2R_PLAN_CACHE_DIR), as JAX's:

    [0:4]   magic b"T2RP"
    [4:8]   u32 LE: byte length of REST
    [8:12]  u32 LE: crc32 of REST
    [12:]   REST = u32 LE header length + header JSON + payload JSON
            ({"plan": ShardingPlan.to_json(), "table": [...]})

Integrity (magic, exact length, CRC) is verified before the header is
parsed, the key before the payload is decoded, a forged length is refused
before anything is read into memory for it, and the payload is JSON,
never pickle. A corrupt or mismatched entry is a typed `PlanCacheCorrupt`
/ `PlanCacheKeyMismatch`: `load()` logs it and returns None (a fresh
search); it is never trusted.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import tempfile
import zlib
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from tensor2robot_tpu_torch import flags

__all__ = [
    "PLAN_CACHE_FORMAT_VERSION",
    "PLAN_CACHE_MAGIC",
    "MAX_PLAN_ENTRY_BYTES",
    "PlanCacheError",
    "PlanCacheCorrupt",
    "PlanCacheKeyMismatch",
    "cache_dir",
    "device_topology",
    "entry_path",
    "load",
    "model_fingerprint",
    "pack_entry",
    "store",
    "unpack_entry",
]

PLAN_CACHE_MAGIC = b"T2RP"
#: The planner schema version: bump when the factorization space or the
#: ShardingPlan schema changes.
PLAN_CACHE_FORMAT_VERSION = 1
_HEADER_SIZE = 12  # magic + length + crc32

#: Hard bound on one cache entry: a forged length field is refused before
#: any allocation. Plans and their measured tables are small JSON.
MAX_PLAN_ENTRY_BYTES = 1 << 24

_LOG = logging.getLogger(__name__)


class PlanCacheError(RuntimeError):
    """Base class for plan-cache failures."""


class PlanCacheCorrupt(PlanCacheError):
    """The envelope failed integrity (magic/length/CRC/JSON): a truncated
    or bit-flipped file. The caller re-runs the search."""


class PlanCacheKeyMismatch(PlanCacheError):
    """The envelope is intact but keyed for a different model, topology,
    torch version, or planner schema: its winner was ranked under
    different rules. The caller re-runs the search."""


def cache_dir() -> Optional[str]:
    """The cache directory in effect (T2R_PLAN_CACHE_DIR), or None when
    the cache is disabled (the default: no file is read or written)."""
    return flags.get_str("T2R_PLAN_CACHE_DIR") or None


def device_topology() -> Dict[str, Any]:
    """What the cache keys the hardware on: the platform ("cuda" where a
    card is visible, else "cpu"), the device's name and compute
    capability ("sm_90" on an H100; None on the CPU) and the world's
    ranks."""
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        return {"platform": "cuda", "device_name": torch.cuda.get_device_name(),
                "compute_capability": f"sm_{major}{minor}", "world_size": ranks}
    return {"platform": "cpu", "device_name": "cpu", "compute_capability": None,
            "world_size": ranks}


def model_fingerprint(model_spec) -> str:
    """sha256 hex over everything the search's outcome depends on from
    the model side: every entry's (name, flax shape, dtype) and the
    geometry fields the feasibility gates consult."""

    def signature(entries) -> list:
        return [[name, list(leaf.shape), leaf.dtype]
                for name, leaf in sorted((entries or {}).items())]

    doc = {
        "params": signature(model_spec.param_shapes),
        "opt": signature(model_spec.opt_shapes),
        "batch": signature(model_spec.batch_shapes),
        "has_ema": bool(model_spec.has_ema),
        "batch_size": model_spec.batch_size,
        "seq_len": model_spec.seq_len,
        "num_heads": model_spec.num_heads,
        "head_dim": model_spec.head_dim,
        "num_layers": model_spec.num_layers,
        "d_model": model_spec.d_model,
        "pipeline_capable": bool(model_spec.pipeline_capable),
    }
    blob = json.dumps(doc, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def entry_path(directory: str, fingerprint: str) -> str:
    """One file per model fingerprint; topology, torch and schema live in
    the header key, so a topology change on the same model is a typed
    mismatch rather than a silent parallel file."""
    return os.path.join(directory, f"plan_{fingerprint[:16]}.bin")


def pack_entry(
    fingerprint: str,
    payload_doc: Mapping[str, Any],
    topology: Optional[Mapping[str, Any]] = None,
    torch_version: Optional[str] = None,
    format_version: int = PLAN_CACHE_FORMAT_VERSION,
) -> bytes:
    """payload_doc ({"plan": ..., "table": ...}) -> envelope bytes."""
    header = {
        "format_version": int(format_version),
        "fingerprint": str(fingerprint),
        "topology": dict(topology if topology is not None else device_topology()),
        "torch": torch_version if torch_version is not None else torch.__version__,
    }
    header_bytes = json.dumps(header, sort_keys=True).encode()
    payload = json.dumps(dict(payload_doc), sort_keys=True).encode()
    rest = struct.pack("<I", len(header_bytes)) + header_bytes + payload
    return (
        PLAN_CACHE_MAGIC
        + struct.pack("<I", len(rest))
        + struct.pack("<I", zlib.crc32(rest) & 0xFFFFFFFF)
        + rest
    )


def unpack_entry(
    blob: bytes,
    expect_fingerprint: Optional[str] = None,
    expect_topology: Optional[Mapping[str, Any]] = None,
    expect_torch: Optional[str] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Envelope -> (header, payload doc). Integrity first (typed
    PlanCacheCorrupt), then the full key (typed PlanCacheKeyMismatch),
    then, and only then, the payload JSON is decoded."""
    if len(blob) < _HEADER_SIZE:
        raise PlanCacheCorrupt(
            f"plan-cache entry truncated at {len(blob)} bytes"
        )
    if blob[:4] != PLAN_CACHE_MAGIC:
        raise PlanCacheCorrupt(
            f"bad magic {blob[:4]!r} (want {PLAN_CACHE_MAGIC!r})"
        )
    (length,) = struct.unpack("<I", blob[4:8])
    (crc,) = struct.unpack("<I", blob[8:12])
    if length > MAX_PLAN_ENTRY_BYTES:
        raise PlanCacheCorrupt(
            f"forged length {length} exceeds the format bound"
        )
    rest = blob[_HEADER_SIZE:]
    if len(rest) != length:
        raise PlanCacheCorrupt(
            f"length field says {length} bytes, file carries {len(rest)}"
        )
    if zlib.crc32(rest) & 0xFFFFFFFF != crc:
        raise PlanCacheCorrupt("crc mismatch: plan-cache bytes are corrupt")
    if len(rest) < 4:
        raise PlanCacheCorrupt("envelope too short for a header")
    (hlen,) = struct.unpack("<I", rest[:4])
    if hlen > len(rest) - 4:
        raise PlanCacheCorrupt(f"header length {hlen} overruns the envelope")
    try:
        header = json.loads(rest[4 : 4 + hlen].decode())
    except (UnicodeDecodeError, ValueError) as err:
        raise PlanCacheCorrupt(f"header is not JSON: {err}") from err
    if not isinstance(header, dict):
        raise PlanCacheCorrupt(f"header is {type(header).__name__}, not dict")
    _check_key(header, expect_fingerprint, expect_topology, expect_torch)
    try:
        payload = json.loads(rest[4 + hlen :].decode())
    except (UnicodeDecodeError, ValueError) as err:
        raise PlanCacheCorrupt(f"payload is not JSON: {err}") from err
    if not isinstance(payload, dict) or "plan" not in payload:
        raise PlanCacheCorrupt("payload carries no plan document")
    return header, payload


def _check_key(
    header: Mapping[str, Any],
    expect_fingerprint: Optional[str],
    expect_topology: Optional[Mapping[str, Any]],
    expect_torch: Optional[str],
) -> None:
    if header.get("format_version") != PLAN_CACHE_FORMAT_VERSION:
        raise PlanCacheKeyMismatch(
            f"planner schema {header.get('format_version')} != "
            f"{PLAN_CACHE_FORMAT_VERSION}: the entry was ranked under a "
            "different search space"
        )
    expect_torch = expect_torch if expect_torch is not None else torch.__version__
    if header.get("torch") != expect_torch:
        raise PlanCacheKeyMismatch(
            f"plan was measured under torch {header.get('torch')}, this "
            f"process runs {expect_torch}: measured costs are not stable "
            "across runtimes"
        )
    if (
        expect_fingerprint is not None
        and header.get("fingerprint") != expect_fingerprint
    ):
        raise PlanCacheKeyMismatch(
            "model fingerprint mismatch: the cached winner was searched "
            "for a different model "
            f"({header.get('fingerprint')} != {expect_fingerprint})"
        )
    if expect_topology is not None:
        got = header.get("topology") or {}
        if dict(got) != dict(expect_topology):
            raise PlanCacheKeyMismatch(
                f"device topology mismatch: plan searched on {got}, "
                f"this host is {dict(expect_topology)}"
            )


def store(
    fingerprint: str,
    payload_doc: Mapping[str, Any],
    directory: Optional[str] = None,
    topology: Optional[Mapping[str, Any]] = None,
) -> Optional[str]:
    """Writes one entry atomically (a temporary file renamed over it: a
    reader never sees a half-written envelope; the CRC catches torn
    storage underneath). Returns the path, or None when the cache is
    disabled."""
    directory = directory if directory is not None else cache_dir()
    if not directory:
        return None
    os.makedirs(directory, exist_ok=True)
    path = entry_path(directory, fingerprint)
    blob = pack_entry(fingerprint, payload_doc, topology=topology)
    fd, tmp = tempfile.mkstemp(
        dir=directory, prefix=os.path.basename(path) + ".tmp."
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load(
    fingerprint: str,
    directory: Optional[str] = None,
    topology: Optional[Mapping[str, Any]] = None,
) -> Optional[Dict[str, Any]]:
    """Tolerant read: the payload doc on a valid hit, None on a miss or
    any typed failure (corrupt / key mismatch: logged, never trusted).
    Strict callers use `unpack_entry` directly."""
    directory = directory if directory is not None else cache_dir()
    if not directory:
        return None
    path = entry_path(directory, fingerprint)
    try:
        with open(path, "rb") as f:
            blob = f.read(MAX_PLAN_ENTRY_BYTES + _HEADER_SIZE + 1)
    except FileNotFoundError:
        return None
    except OSError as err:
        _LOG.warning("plan cache unreadable at %s: %s", path, err)
        return None
    expect_topology = dict(topology) if topology is not None else device_topology()
    try:
        _, payload = unpack_entry(
            blob,
            expect_fingerprint=fingerprint,
            expect_topology=expect_topology,
        )
    except PlanCacheError as err:
        _LOG.warning(
            "plan cache entry %s rejected (%s): %s; falling back to a "
            "fresh search",
            path,
            type(err).__name__,
            err,
        )
        return None
    return payload
