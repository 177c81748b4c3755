"""The persistent compile cache for serving and exporting processes.

Port of tensor2robot_tpu/serving/compile_cache.py, behind the same
`T2R_COMPILE_CACHE_DIR` flag. In the JAX package the cache holds the XLA
compile of each bucket, which every boot otherwise pays. In the port a
bucket either runs its AOT package (export/aot.py) or the exported
program eagerly, and neither compiles at restore: what compiles is the
export-side build of the packages (Inductor's generated code and its
Triton kernels). So here the tier points Inductor's and Triton's on-disk
caches (`TORCHINDUCTOR_CACHE_DIR`, `TRITON_CACHE_DIR`, under
`<dir>/inductor` and `<dir>/triton`) at the directory; a later build of
the same program on the host, in this process or a build process it
spawns, reads its kernels from disk.

The server keeps JAX's labels all the same: `snapshot()["prewarm_source"]`
says "aot" for a bucket served from a package, and "cache" or "compile"
(as this flag is set or not) for one that runs the exported program, so
fleet snapshots of both packages read alike. `enable_compile_cache_for`
is the restore-time entry point: a version whose warmup ladder is wholly
covered by loaded packages skips the tier, as in the JAX package.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

from tensor2robot_tpu_torch import flags as t2r_flags

__all__ = ["enable_compile_cache", "enable_compile_cache_for"]


def enable_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Points Inductor's and Triton's on-disk caches at a directory.

    Resolution: explicit `cache_dir` argument > `T2R_COMPILE_CACHE_DIR`
    flag > disabled (returns None, nothing touched). Returns the directory
    in effect. Call it before the process's first compile: Inductor keeps
    some of its cache state in memory, which is dropped here when Inductor
    is already loaded.
    """
    if cache_dir is None:
        cache_dir = t2r_flags.get_str("T2R_COMPILE_CACHE_DIR")
    if not cache_dir:
        return None
    cache_dir = os.path.abspath(cache_dir)
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache_dir, "inductor")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache_dir, "triton")
    utils = sys.modules.get("torch._inductor.utils")
    if utils is not None:
        utils.clear_caches()
    return cache_dir


def enable_compile_cache_for(loaded) -> Optional[str]:
    """Restore-time engagement for one loaded export version.

    When the version serves EVERY bucket of its resolved ladder
    (T2R_SERVE_BUCKETS included, serving/buckets.py) from loaded AOT
    packages, the tier is skipped (returns None; a cache already enabled
    is left as it is). Otherwise behaves exactly like
    `enable_compile_cache()`. A server constructed with an explicit
    `batch_buckets` ladder is invisible from here; `PolicyServer`
    re-engages at start() for any bucket outside the AOT table.
    """
    if loaded is not None and getattr(loaded, "aot_covered", False):
        from tensor2robot_tpu_torch.serving import buckets as buckets_lib

        table = getattr(loaded, "aot_executables", None) or {}
        try:
            ladder = buckets_lib.resolve_buckets(
                None, getattr(loaded, "metadata", None) or {})
        except ValueError:
            ladder = ()
        if ladder and all(bucket in table for bucket in ladder):
            return None
    return enable_compile_cache()
