"""Crash-consistent checkpoints: detect, skip and quarantine torn ones;
publish a verifiable manifest per step.

Port of tensor2robot_tpu/train/durability.py, in the port's own layout:
one file `<model_dir>/checkpoints/<step>.pt` per step (train/state.py),
written under `<step>.pt.<pid>.tmp`, fsynced, renamed into place and the
directory fsynced. The rename alone proves little to a reader: a copy, a
disk or a crash without the fsync can leave a final-named file short or
damaged. So after the fsynced rename the writer publishes
`<step>.durable.json`, the file's size and SHA-256, itself written
tmp-then-`os.replace`. The verdict on a step is the JAX package's four-way
one:

  * a `.tmp` name                              -> torn (uncommitted write)
  * manifest present, size (and digest) agree  -> durable
  * manifest present, file missing or differs  -> torn
  * no manifest: structural fallback — a whole torch.save archive (its
    zip directory, written last, reads back and names a data.pkl). It
    covers checkpoints written without a manifest and the moment between
    the rename and the manifest.

Listing (`validate`, `durable_steps`) checks sizes; `load_durable` reads
the file once and checks the digest of the very bytes it unpickles, so a
file torn or replaced between a listing and a load is never restored.

The writer (the trainer owns `checkpoints/`) also quarantines torn files
and stale `.tmp` files into `<model_dir>/quarantine/` at startup
(`sweep_torn_checkpoints`), so a resumed run re-saves the replayed steps
without colliding with the wreckage. Readers (continuous eval, the
checkpoint predictor) only skip: a `.tmp` they see may be a live write.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import shutil
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import torch

from tensor2robot_tpu_torch.train import state as state_lib

MANIFEST_VERSION = 1
QUARANTINE_DIRNAME = "quarantine"
_TMP_SUFFIX = ".tmp"


class TornCheckpoint(RuntimeError):
    """A checkpoint file that does not verify against its manifest or does
    not load."""


def quarantine_root(model_dir: str) -> str:
    return os.path.abspath(os.path.join(model_dir, QUARANTINE_DIRNAME))


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _read_manifest(model_dir: str, step: int) -> Optional[Dict[str, Any]]:
    """The step's manifest, None when there is none; raises ValueError
    when it cannot be read."""
    path = state_lib.manifest_path(model_dir, step)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as err:
        raise ValueError(f"unreadable durability manifest: {err}") from err
    if not (isinstance(manifest, dict) and isinstance(manifest.get("size"), int)
            and isinstance(manifest.get("sha256"), str)):
        raise ValueError(f"durability manifest without size and sha256: {manifest!r}")
    return manifest


def _structural_reason(data_or_path) -> Optional[str]:
    """None when the bytes (or file) are a whole torch.save archive."""
    try:
        source = io.BytesIO(data_or_path) if isinstance(data_or_path, bytes) else data_or_path
        with zipfile.ZipFile(source) as archive:
            names = archive.namelist()
    except (OSError, zipfile.BadZipFile) as err:
        return f"not a whole torch.save archive: {err}"
    if not any(name.endswith("/data.pkl") or name == "data.pkl" for name in names):
        return "torch.save archive without data.pkl"
    return None


def write_manifest(model_dir: str, step: int) -> None:
    """Publishes the manifest of a committed `<step>.pt` (call only after
    its fsynced rename)."""
    with open(state_lib.checkpoint_path(model_dir, step), "rb") as f:
        data = f.read()
    manifest = {
        "version": MANIFEST_VERSION,
        "file": os.path.basename(state_lib.checkpoint_path(model_dir, step)),
        "size": len(data),
        "sha256": _digest(data),
    }
    path = state_lib.manifest_path(model_dir, step)
    tmp = f"{path}.{os.getpid()}{_TMP_SUFFIX}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def validate(model_dir: str, step: int) -> Optional[str]:
    """None when `<step>.pt` is durable by its size (or, without a
    manifest, by its structure), else the reason it is torn. Read-only:
    safe on a directory a trainer is writing."""
    path = state_lib.checkpoint_path(model_dir, step)
    if not os.path.isfile(path):
        return "checkpoint file missing"
    try:
        manifest = _read_manifest(model_dir, step)
    except ValueError as err:
        return str(err)
    if manifest is None:
        return _structural_reason(path)
    actual = os.path.getsize(path)
    if actual != manifest["size"]:
        return f"size mismatch: {actual} bytes, manifest says {manifest['size']}"
    return None


def durable_steps(model_dir: str) -> List[int]:
    """Steps under model_dir/checkpoints that validate, ascending."""
    return [step for step in state_lib.checkpoint_steps(model_dir)
            if validate(model_dir, step) is None]


def latest_durable_step(model_dir: str) -> Optional[int]:
    steps = durable_steps(model_dir)
    return steps[-1] if steps else None


def read_verified(model_dir: str, step: int) -> bytes:
    """The bytes of `<step>.pt`, read once and verified: their digest
    against the manifest, or the archive's structure without one. Raises
    TornCheckpoint otherwise."""
    path = state_lib.checkpoint_path(model_dir, step)
    try:
        manifest = _read_manifest(model_dir, step)
        with open(path, "rb") as f:
            data = f.read()
    except (OSError, ValueError) as err:
        raise TornCheckpoint(f"{path}: {err}") from err
    if manifest is not None:
        if len(data) != manifest["size"] or _digest(data) != manifest["sha256"]:
            raise TornCheckpoint(
                f"{path}: {len(data)} bytes do not match the manifest's "
                f"{manifest['size']} bytes and digest")
    else:
        reason = _structural_reason(data)
        if reason is not None:
            raise TornCheckpoint(f"{path}: {reason}")
    return data


def load_durable(model_dir: str, step: int, map_location: Any = "cpu") -> Dict[str, Any]:
    """The checkpoint of `step` from verified bytes (read_verified);
    raises TornCheckpoint when they do not verify or do not load."""
    data = read_verified(model_dir, step)
    try:
        return torch.load(io.BytesIO(data), map_location=map_location,
                          weights_only=True)
    except Exception as err:  # noqa: BLE001 — whatever the unpickler raises
        raise TornCheckpoint(
            f"{state_lib.checkpoint_path(model_dir, step)}: "
            f"{type(err).__name__}: {err}") from err


def load_newest_durable(model_dir: str, map_location: Any = "cpu") -> Optional[Dict[str, Any]]:
    """The newest checkpoint that verifies and loads, or None. Every torn
    step on the way is logged and skipped."""
    for step in reversed(state_lib.checkpoint_steps(model_dir)):
        reason = validate(model_dir, step)
        if reason is None:
            try:
                return load_durable(model_dir, step, map_location)
            except TornCheckpoint as err:
                reason = str(err)
        logging.warning("Skipping torn checkpoint %s: %s",
                        state_lib.checkpoint_path(model_dir, step), reason)
    return None


def sweep_torn_checkpoints(model_dir: str) -> List[Tuple[str, str]]:
    """Writer-only startup sweep: moves torn `<step>.pt` files (with their
    manifests) and stale `.tmp` files into `<model_dir>/quarantine/`.
    Never deletes: the quarantined files are the crash's evidence. Returns
    [(file name, reason)]. Only the process that owns the checkpoint
    directory may call it: a reader would quarantine a live write."""
    root = state_lib.checkpoint_dir(model_dir)
    if not os.path.isdir(root):
        return []
    torn: List[Tuple[str, str]] = []
    for entry in sorted(os.listdir(root)):
        if entry.endswith(_TMP_SUFFIX):
            torn.append((entry, "uncommitted write (.tmp)"))
    for step in state_lib.checkpoint_steps(model_dir):
        reason = validate(model_dir, step)
        if reason is None:
            try:
                read_verified(model_dir, step)
            except TornCheckpoint as err:
                reason = str(err)
        if reason is not None:
            torn.append((os.path.basename(state_lib.checkpoint_path(model_dir, step)),
                         reason))
            manifest = state_lib.manifest_path(model_dir, step)
            if os.path.exists(manifest):
                torn.append((os.path.basename(manifest), f"manifest of a torn step: {reason}"))
    if not torn:
        return []
    quarantine = quarantine_root(model_dir)
    os.makedirs(quarantine, exist_ok=True)
    stamp = int(time.time() * 1e3)
    for name, reason in torn:
        dest = os.path.join(quarantine, f"{name}.{stamp}")
        while os.path.exists(dest):
            dest += "x"
        shutil.move(os.path.join(root, name), dest)
        logging.warning("Quarantined torn checkpoint %s -> %s (%s)",
                        os.path.join(root, name), dest, reason)
    return torn


def publish_durable(model_dir: str, step: int) -> bool:
    """Writes the manifest of `step` if its file exists, is a whole
    archive, and has none yet. True when a manifest is present after the
    call. Call only after the step's fsynced rename."""
    path = state_lib.checkpoint_path(model_dir, step)
    if not os.path.isfile(path):
        return False
    if os.path.exists(state_lib.manifest_path(model_dir, step)):
        return True
    if _structural_reason(path) is not None:
        return False  # torn though final-named: never blessed
    write_manifest(model_dir, step)
    return True
