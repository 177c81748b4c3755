"""AOT-compiled serving packages inside the export artifact.

Port of tensor2robot_tpu/export/aot.py. An export ships its serving
programs (`program/*.pt2`, torch.export) and the warmup corpus that names
every batch the fleet dispatches (`warmup_batch_sizes`). What a consumer
still pays per process is running those programs eagerly, op by op. This
module compiles each bucket ahead of time, at export: per warmup bucket
(and per serve-quant regime) the exporter loads the just-saved program,
re-exports its module at the bucket's concrete batch (static shapes, as
JAX specializes its rehydrated program), and compiles it with
AOTInductor (`torch._inductor.aoti_compile_and_package`) into `aot/` of
the export. Restore loads the package instead, but ONLY when the key
matches, because a compiled package means nothing off the exact
(program, weights, hardware, toolchain) it was built for:

  * **artifact fingerprint**: sha256 over the regime's program bytes
    (each static program's, for a set of them) plus, for a serve-quant
    regime, its payload bytes. The f32 program holds its weights, so its
    bytes cover them. A stale or transplanted `aot/` can never serve
    another artifact's weights.
  * **device topology**: platform, device name, compute capability
    ("sm_90" on an H100; the CPU's vector ISA) and device count, as
    parallel/plan_cache.py keys its plans, where JAX keys (platform,
    device kind, device count). An export built on one device and served
    on another is a typed `topology_mismatch` fallback, never a load.
  * **torch and CUDA versions** (JAX keys its jax version): a package's
    shared object is not portable across them.

Any mismatch falls back LOUDLY (typed, counted, surfaced per bucket in
`server.snapshot()["prewarm_source"]`) to the eager exported program.

Envelope (one file per (regime, bucket), `aot/exec_<regime>_b<n>.bin`):

    [0:4]   magic b"T2RA"
    [4:8]   u32 LE: byte length of REST
    [8:12]  u32 LE: crc32 of REST
    [12:]   REST = u32 LE header length + header JSON + the AOTInductor
            package's bytes

The 12-byte head is the replay frame's shape, so the JAX package's
`analysis/corpus.py corrupt_frame_variants` drives the corruption tests.
Integrity (magic, exact length with MAX_EXECUTABLE_BYTES checked first,
CRC) is verified before the header is parsed, and the key before the
package is written out and loaded, from the verified bytes only.

A package holds the program's custom operators opaque (`t2r_torch::
flash_fwd`, which launches the kernel B2 on the card, and `t2r_torch::
quant_bmm`) and calls them through AOTInductor's proxy executor, so the
process that loads it registers them first (`_register_ops`). Unlike
JAX's, an AOT hit is not bit for bit the eager program: Inductor fuses
the elementwise ops around the contractions. Packages are built with
TF32 off, as the port's f32 serving runs.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import io
import json
import multiprocessing
import os
import struct
import tempfile
import threading
import time
import zlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "AOT_DIR",
    "AOT_FORMAT_VERSION",
    "AOT_MAGIC",
    "AOTError",
    "AOTCorrupt",
    "AOTKeyMismatch",
    "aot_relpath",
    "device_topology",
    "digest",
    "artifact_fingerprint",
    "feature_signature",
    "build_bucket_executables",
    "load_executable",
    "load_exported",
]

AOT_DIR = "aot"
AOT_FORMAT_VERSION = 1
AOT_MAGIC = b"T2RA"
_HEADER_SIZE = 12  # magic + length + crc32, the corpus frame shape

#: Hard bound on a single package file; a forged length field must be
#: rejected before any allocation happens (corpus frame_huge_length).
MAX_EXECUTABLE_BYTES = 1 << 30


class AOTError(RuntimeError):
    """Base class for AOT-package failures (export or restore side)."""


class AOTCorrupt(AOTError):
    """The envelope failed integrity (magic/length/CRC/load): a truncated
    or bitflipped file. Restore falls back to the next tier."""


class AOTKeyMismatch(AOTError):
    """The envelope is intact but keyed for a different artifact,
    topology, or torch/CUDA version: loading it would run the wrong
    program on the wrong data or hardware. Restore falls back LOUDLY."""


def aot_relpath(regime: str, bucket: int) -> str:
    """Artifact-relative path of one bucket's package envelope."""
    return os.path.join(AOT_DIR, f"exec_{regime}_b{int(bucket)}.bin")


def device_topology(device: Union[None, str, torch.device] = None) -> Dict[str, Any]:
    """The topology key of `device` in THIS process (the card when one is
    visible and no device is named): a package built here runs only where
    the same key holds."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        major, minor = torch.cuda.get_device_capability(index)
        return {"platform": "cuda", "device_name": torch.cuda.get_device_name(index),
                "compute_capability": f"sm_{major}{minor}",
                "device_count": torch.cuda.device_count()}
    return {"platform": device.type, "device_name": device.type,
            "compute_capability": torch.backends.cpu.get_cpu_capability(),
            "device_count": 1}


def runtime_versions() -> Dict[str, Optional[str]]:
    """The toolchain key: a package's shared object links this torch."""
    return {"torch": torch.__version__, "cuda": torch.version.cuda}


def digest(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def artifact_fingerprint(regime: str, chunk_digests: Sequence[bytes]) -> str:
    """Hex fingerprint binding a package to its (program, weights) pair:
    the same construction as the JAX package's, over the sha256 digests
    of the regime's program bytes and (for a serve-quant regime) its
    payload bytes."""
    h = hashlib.sha256()
    h.update(f"t2r-aot-v{AOT_FORMAT_VERSION}:{regime}".encode())
    for chunk in chunk_digests:
        h.update(chunk)
    return h.hexdigest()


def _dtype_name(value) -> str:
    if isinstance(value, torch.Tensor):
        return str(value.dtype).rsplit(".", 1)[-1]
    return np.dtype(np.asarray(value).dtype).name


def feature_signature(batch: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """{key: {shape, dtype}} of a concrete feature batch: the exact input
    contract the package was compiled for. Restore dispatches to the
    package only on an exact match; anything else is the eager path's."""
    return {
        str(key): {"shape": [int(d) for d in tuple(value.shape)],
                   "dtype": _dtype_name(value)}
        for key, value in batch.items()
    }


def _pack(header: Dict[str, Any], payload: bytes) -> bytes:
    header_bytes = json.dumps(header, sort_keys=True).encode()
    rest = struct.pack("<I", len(header_bytes)) + header_bytes + payload
    return (
        AOT_MAGIC
        + struct.pack("<I", len(rest))
        + struct.pack("<I", zlib.crc32(rest) & 0xFFFFFFFF)
        + rest
    )


def _unpack(blob: bytes) -> Tuple[Dict[str, Any], bytes]:
    """Envelope -> (header, package bytes); integrity only, no keys."""
    if len(blob) < _HEADER_SIZE:
        raise AOTCorrupt(f"executable file truncated at {len(blob)} bytes")
    if blob[:4] != AOT_MAGIC:
        raise AOTCorrupt(f"bad magic {blob[:4]!r} (want {AOT_MAGIC!r})")
    (length,) = struct.unpack("<I", blob[4:8])
    (crc,) = struct.unpack("<I", blob[8:12])
    if length > MAX_EXECUTABLE_BYTES:
        raise AOTCorrupt(f"forged length {length} exceeds the format bound")
    rest = blob[_HEADER_SIZE:]
    if len(rest) != length:
        raise AOTCorrupt(
            f"length field says {length} bytes, file carries {len(rest)}"
        )
    if zlib.crc32(rest) & 0xFFFFFFFF != crc:
        raise AOTCorrupt("crc mismatch: executable bytes are corrupt")
    if len(rest) < 4:
        raise AOTCorrupt("envelope too short for a header")
    (hlen,) = struct.unpack("<I", rest[:4])
    if hlen > len(rest) - 4:
        raise AOTCorrupt(f"header length {hlen} overruns the envelope")
    try:
        header = json.loads(rest[4 : 4 + hlen].decode())
    except (UnicodeDecodeError, ValueError) as err:
        raise AOTCorrupt(f"header is not JSON: {err}") from err
    if not isinstance(header, dict):
        raise AOTCorrupt("header is not a JSON object")
    return header, rest[4 + hlen :]


def _check_key(
    header: Mapping[str, Any],
    expect_fingerprint: Optional[str],
    expect_topology: Optional[Mapping[str, Any]],
) -> None:
    if header.get("format_version") != AOT_FORMAT_VERSION:
        raise AOTKeyMismatch(
            f"format_version {header.get('format_version')} != "
            f"{AOT_FORMAT_VERSION}"
        )
    for key, mine in runtime_versions().items():
        if header.get(key) != mine:
            raise AOTKeyMismatch(
                f"package was built under {key} {header.get(key)}, this "
                f"process runs {mine}: a package's shared object is not "
                "portable across versions"
            )
    if (
        expect_fingerprint is not None
        and header.get("fingerprint") != expect_fingerprint
    ):
        raise AOTKeyMismatch(
            "artifact fingerprint mismatch: the package was compiled "
            "from a different (program, weights) pair than this artifact "
            f"carries ({header.get('fingerprint')} != {expect_fingerprint})"
        )
    if expect_topology is not None:
        got = header.get("topology") or {}
        if dict(got) != dict(expect_topology):
            raise AOTKeyMismatch(
                f"device topology mismatch: package built for {got}, "
                f"this host is {dict(expect_topology)}"
            )


#: A package against the program it was compiled from, on its bucket's
#: warmup batch at export: every output within this abs + rel tolerance
#: (the port's served-action gate). Inductor fuses the elementwise ops
#: around the contractions, so the two agree to rounding, not bit for bit.
PACKAGE_PARITY_TOL = 1e-4


def check_package(runner, program, batch: Mapping[str, Any], payload,
                  device: Union[str, torch.device],
                  tolerance: Optional[float] = None) -> float:
    """Runs a loaded package and the program module it was compiled from
    on one concrete batch (with the regime's payload, or None); returns the
    largest |package - program| / (1 + |program|) and raises AOTError
    above `tolerance` (PACKAGE_PARITY_TOL): a package that does not compute
    its program never ships. The program runs eagerly, so under
    saved_model.TRACE_LOCK: exports in other threads may be tracing."""
    from tensor2robot_tpu_torch.export.saved_model import TRACE_LOCK

    if tolerance is None:
        tolerance = PACKAGE_PARITY_TOL
    target = torch.device(device)
    features = {key: torch.as_tensor(np.asarray(value)).to(target)
                for key, value in batch.items()}
    args = (features,) if payload is None else (payload, features)
    with TRACE_LOCK, torch.no_grad():
        want, got = program(*args), runner(*args)
    worst = 0.0
    for key, value in want.items():
        value = value.float()
        err = (got[key].float() - value).abs() / (1.0 + value.abs())
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
    if not worst <= tolerance:
        raise AOTError(f"package diverges from its program by {worst:.3e} of "
                       f"(1 + |program|) on bucket {bucket_of(batch)} (limit {tolerance})")
    return worst


_LOAD_LOCK = threading.Lock()


def load_exported(source) -> torch.export.ExportedProgram:
    """torch.export.load of a path or file object under a process-wide
    lock: torch.export's deserializer is process-global state, so two loads
    in two threads (exports side by side, a hot swap beside a boot)
    collide ("_CURRENT_DESERIALIZER is already set")."""
    with _LOAD_LOCK:
        return torch.export.load(source)


def load_program(program_bytes: bytes, prefix: Optional[bytes],
                 device: Union[str, torch.device]):
    """(program module, payload on `device` or None) of a regime's saved
    program and payload bytes."""
    _register_ops()
    module = load_exported(io.BytesIO(program_bytes)).module()
    payload = None
    if prefix is not None:
        payload = torch.load(io.BytesIO(prefix), map_location=torch.device(device),
                             weights_only=True)
    return module, payload


def _register_ops() -> None:
    """Registers the port's custom operators a package may call."""
    from tensor2robot_tpu_torch.export import serve_quant  # noqa: F401
    from tensor2robot_tpu_torch.ops import flash_attention  # noqa: F401


def load_executable(
    blob: bytes,
    expect_fingerprint: Optional[str] = None,
    expect_topology: Optional[Mapping[str, Any]] = None,
):
    """Envelope bytes -> (loaded package, header).

    Order of checks is the contract: integrity (AOTCorrupt) before the
    key (AOTKeyMismatch) before the package is written out and loaded: a
    mismatched package is never loaded, let alone run. The loaded package
    is called like the program it was compiled from.
    """
    header, package = _unpack(blob)
    _check_key(header, expect_fingerprint, expect_topology)
    try:
        _register_ops()
        import torch._inductor.config as inductor_config

        # A CUDA package was built with no host vector ISA (_compile), and
        # is loaded so: AOTInductor's load compares the ISA it records with
        # the loading process's, whose first probe compiles and loads
        # several programs (seconds to tens of seconds a process).
        no_isa_probe = (inductor_config.patch({"cpp.vec_isa_ok": False})
                        if (header.get("topology") or {}).get("platform") == "cuda"
                        else contextlib.nullcontext())
        with tempfile.TemporaryDirectory(prefix="t2r-aot-") as tmp, no_isa_probe:
            path = os.path.join(tmp, "package.pt2")
            with open(path, "wb") as f:
                f.write(package)
            runner = torch._inductor.aoti_load_package(path)
    except Exception as err:  # noqa: BLE001 — any load failure of a
        # CRC-clean payload means an incompatible writer; typed so restore
        # can fall back.
        raise AOTCorrupt(
            f"package failed to load: {type(err).__name__}: {err}"
        ) from err
    return runner, header


def _compile_bucket(*args) -> Tuple[bytes, float]:
    """Runs in a spawned build process (see _compile); a failure comes back
    as an AOTError carrying the build's traceback as text, since the
    exception itself may not pickle."""
    try:
        return _compile(*args)
    except Exception as err:  # noqa: BLE001 — crosses the process boundary
        import traceback

        raise AOTError(f"{type(err).__name__}: {err}\n"
                       f"{traceback.format_exc()[-6000:]}") from None


def _compile(program_bytes: bytes, batch: Dict[str, torch.Tensor],
             prefix: Optional[bytes], device: str, threads: int) -> Tuple[bytes, float]:
    """Loads the program, re-exports its module at the batch's concrete
    shapes (`batch` holds meta tensors: the shapes and dtypes are the
    contract, not the values) and compiles it; returns the package's bytes
    and the milliseconds the export and compile took."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(threads)
    import torch._inductor.config as inductor_config

    # The buckets are the parallelism (one process each): a bucket compiles
    # its kernels in its own process, with no pool of compile workers to
    # start. One launch configuration a pointwise or reduction kernel, none
    # benchmarked (the build's time goes to compiling, and a package is
    # fixed once built); division rounded as eager CUDA rounds it (Triton's
    # `/` is approximate) and fp16 intermediates kept as eager keeps them.
    inductor_config.compile_threads = 1
    settings = [("triton.autotune_pointwise", False), ("deterministic", True),
                ("eager_numerics.division_rounding", True),
                ("emulate_precision_casts", True),
                # The wrapper only sequences launches, and is compiled once
                # a process: a precompiled header would cost more than it
                # saves.
                ("aot_inductor.compile_wrapper_opt_level", "O0"),
                ("aot_inductor.precompile_headers", False)]
    if torch.device(device).type == "cuda":
        # A CUDA package's host code runs no vector loop: no probe of the
        # host's vector ISAs (several compiles and loads a process), and a
        # wrapper built with no ISA flags, so any x86-64 host loads it.
        settings.append(("cpp.vec_isa_ok", False))
    for name, value in settings:
        *parents, leaf = name.split(".")
        node = inductor_config
        for part in parents:
            node = getattr(node, part, None)
        if node is not None and hasattr(node, leaf):  # absent in older torch
            setattr(node, leaf, value)
    cxx = _openmp_compiler()
    if cxx is not None:
        inductor_config.cpp.cxx = (cxx,)
    _register_ops()
    start = time.monotonic()
    target = torch.device(device)
    module = load_exported(io.BytesIO(program_bytes)).module()
    features = {key: torch.zeros(value.shape, dtype=value.dtype, device=target)
                for key, value in batch.items()}
    args: Tuple = (features,)
    if prefix is not None:
        args = (torch.load(io.BytesIO(prefix), map_location=target,
                           weights_only=True), features)
    with torch.no_grad():
        static = torch.export.export(module, args)
    with _build_lock(batch, device), \
            tempfile.TemporaryDirectory(prefix="t2r-aot-build-") as tmp:
        path = torch._inductor.aoti_compile_and_package(
            static, package_path=os.path.join(tmp, "package.pt2"))
        with open(path, "rb") as f:
            package = f.read()
    return package, (time.monotonic() - start) * 1e3


def _build_lock(batch: Mapping[str, torch.Tensor], device: str):
    """A lock, across the processes sharing Inductor's cache directory,
    for one (device, feature shapes and dtypes). Inductor writes a build's
    files into its cache directory under a key of the generated code, and
    packages them after it has let go of its own lock: a build of the same
    code beside it (another export of the same model, in any process)
    rewrites them meanwhile, and the package takes an emptied file. Equal
    code means equal shapes, so builds that could collide take the same
    lock; the buckets of one export differ in shape and still build side
    by side."""
    from torch._inductor.runtime.cache_dir_utils import cache_dir
    from torch.utils._filelock import FileLock

    signature = repr((str(device), sorted(
        (str(key), tuple(value.shape), str(value.dtype)) for key, value in batch.items())))
    key = hashlib.sha256(signature.encode()).hexdigest()[:32]
    lock_dir = os.path.join(cache_dir(), "locks")
    os.makedirs(lock_dir, exist_ok=True)
    return FileLock(os.path.join(lock_dir, f"t2r-aot-{key}.lock"))


def _openmp_compiler() -> Optional[str]:
    """The C++ compiler Inductor is to build a package with, where its own
    choice cannot: Inductor compiles and links a package with `-fopenmp`,
    and a toolchain named by CXX may ship without libgomp. Returns None
    when Inductor's compiler links OpenMP, else the first of `g++` and
    `c++` on PATH that does (None again when none does: the build then
    fails with Inductor's own error, recorded as its regime's)."""
    import shutil
    import subprocess

    from torch._inductor import cpp_builder

    with tempfile.TemporaryDirectory(prefix="t2r-cxx-") as tmp:
        source = os.path.join(tmp, "probe.cpp")
        with open(source, "w") as f:
            f.write("int main() { return 0; }\n")

        def links_openmp(compiler) -> bool:
            try:
                return subprocess.run(
                    [compiler, "-fopenmp", source, "-o", os.path.join(tmp, "probe")],
                    capture_output=True).returncode == 0
            except OSError:
                return False

        if links_openmp(cpp_builder.get_cpp_compiler()):
            return None
        for name in ("g++", "c++"):
            found = shutil.which(name)
            if found and links_openmp(found):
                return found
    return None


def _serialize(tree) -> bytes:
    buffer = io.BytesIO()
    torch.save(torch.utils._pytree.tree_map(
        lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, tree), buffer)
    return buffer.getvalue()


def meta_batch(batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A feature batch as meta tensors: its shapes and dtypes, no data (a
    build process is sent these, not the batch)."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, torch.Tensor):
            shape, dtype = value.shape, value.dtype
        else:
            shape, dtype = np.shape(value), np.asarray(value).dtype
        out[key] = meta_tensor(shape, dtype)
    return out


def meta_tensor(shape, dtype) -> torch.Tensor:
    """A meta tensor of `shape` and a torch or numpy `dtype`."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty((0,), dtype)).dtype
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def build_packages(jobs: Sequence[Mapping[str, Any]],
                   device: Union[str, torch.device]) -> List[Any]:
    """Compiles every job ({"program": bytes, "batch": features (only
    their shapes and dtypes are sent), "prefix": payload bytes or None})
    in its own spawned process, as many at once as the host has cores
    for; returns, per job, (package bytes, compile ms) or the exception
    that job raised. Spawned, not forked: a fork of a process that has
    started CUDA is unsafe."""
    if not jobs:
        return []
    cores = os.cpu_count() or 2
    workers = min(len(jobs), max(1, cores - 1))
    threads = max(1, cores // workers)
    context = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=workers,
                                                mp_context=context) as pool:
        futures = [pool.submit(_compile_bucket, job["program"], meta_batch(job["batch"]),
                               job.get("prefix"), str(device), threads)
                   for job in jobs]
        results = []
        for future in futures:
            try:
                results.append(future.result())
            except Exception as err:  # noqa: BLE001 — the caller records it
                results.append(err)
    return results


def bucket_of(batch: Mapping[str, Any]) -> int:
    return int(tuple(next(iter(batch.values())).shape)[0])


def envelope(package: bytes, batch: Mapping[str, Any], regime: str, fingerprint: str,
             topology: Mapping[str, Any], has_prefix_arg: bool) -> bytes:
    """One compiled package -> envelope bytes, its key in the header."""
    header = {
        "format_version": AOT_FORMAT_VERSION,
        "regime": str(regime),
        "bucket": bucket_of(batch),
        "fingerprint": fingerprint,
        "topology": dict(topology),
        **runtime_versions(),
        "features": feature_signature(batch),
        # The call's dict order: the package flattens its inputs by it.
        "feature_keys": [str(key) for key in batch],
        "has_prefix_arg": bool(has_prefix_arg),
    }
    return _pack(header, package)


def build_bucket_executables(
    artifact_bytes: Union[bytes, Mapping[int, bytes]],
    batches: Sequence[Mapping[str, Any]],
    regime: str,
    fingerprint: str,
    prefix_args: Tuple = (),
    timings_ms: Optional[Dict[int, float]] = None,
    device: Union[None, str, torch.device] = None,
    parity: Optional[Dict[int, float]] = None,
) -> Dict[int, bytes]:
    """Export-side AOT pass for one regime: compile the saved program at
    each bucket's concrete batch, one spawned build process a bucket
    (capped by host cores), and envelope each package.

    `artifact_bytes` is the regime's program, or {batch: program} for a
    static program set (a forward that takes gradients), whose bucket is
    each program's own batch. `prefix_args` is the leading call argument
    (the serve-quant payload tree) or empty; the feature batch is always
    the trailing argument. Each package is loaded back (one this process
    cannot load would turn every boot into a logged fallback) and held
    against its program on its bucket's batch (check_package). Any bucket
    failing fails the whole regime (the caller's best-effort error
    recording). With `timings_ms` each bucket's wall-clock export +
    compile milliseconds are recorded, with `parity` its check_package
    reading."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if len(prefix_args) > 1:
        raise ValueError("one leading argument at most (the payload tree)")
    prefix = _serialize(prefix_args[0]) if prefix_args else None
    jobs = []
    for batch in batches:
        bucket = bucket_of(batch)
        program = (artifact_bytes if isinstance(artifact_bytes, (bytes, bytearray))
                   else artifact_bytes[bucket])
        jobs.append({"program": bytes(program), "batch": batch, "prefix": prefix})
    topology = device_topology(device)
    out: Dict[int, bytes] = {}
    programs: Dict[int, Any] = {}  # each program loaded once
    for job, result in zip(jobs, build_packages(jobs, device)):
        if isinstance(result, Exception):
            raise result
        package, elapsed_ms = result
        blob = envelope(package, job["batch"], regime, fingerprint, topology,
                        bool(prefix_args))
        runner, _ = load_executable(blob)
        key = id(job["program"])
        if key not in programs:
            programs[key] = load_program(job["program"], prefix, device)
        module, payload = programs[key]
        bucket = bucket_of(job["batch"])
        reading = check_package(runner, module, job["batch"], payload, device)
        out[bucket] = blob
        if timings_ms is not None:
            timings_ms[bucket] = round(elapsed_ms, 3)
        if parity is not None:
            parity[bucket] = reading
    return out
