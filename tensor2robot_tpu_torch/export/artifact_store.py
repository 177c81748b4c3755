"""Content-addressed artifact store with delta-compressed siblings.

Port of tensor2robot_tpu/export/artifact_store.py. One fleet serving N
policy variants needs N artifacts, but sibling fine-tune exports share
almost everything: the serving programs, the AOT packages, the warmup
corpus; and their weights differ by small deltas that quantize far
harder than the weights themselves. The store keeps exports
content-addressed, so shared files cost their bytes ONCE, and keeps a
sibling's weights as a per-leaf delta against a named base, encoded
through the block-scaled codecs the gradient collectives use
(parallel/collectives.py BlockScaledCollective).

Layout under the store root::

    blobs/sha256-<hex>        file contents, content-addressed (dedup)
    policies/<policy_id>.json manifest: file table + weights payload

Weights payloads come in two kinds:

  * ``dense``: the base case, ``variables.pt`` stored verbatim as a blob
    (sha-verified on read).
  * ``delta``: a sibling. Each leaf is taken in the JAX package's flax
    layout under its flat path (the export's ``flax_variables`` table,
    export/saved_model.py; a Linear weight as its [in, out] kernel), so
    its diff ravels, pads and encodes exactly as the JAX store's does and
    the quantized values and scales equal JAX's byte for byte. Entries
    the table does not name keep the torch layout under their own names.
    A per-leaf PARITY GATE re-decodes the quantized diff against the base
    during ``put``: a leaf that does not reconstruct within the tolerance
    (``T2R_POLICY_DELTA_TOL``, relative L-inf) ships dense-exact instead.

Where the JAX store hashes msgpack bytes, this one hashes a canonical
form of the weights (`weights_digest`: every tensor in sorted name order
with its dtype and shape, as raw bytes), because ``torch.save`` bytes
depend on the file they are written to. The manifest records the
reconstructed weights' digest, so ``load_weights`` is self-verifying.
The delta payload is a ``torch.save`` of the encoded leaves, read with
``weights_only=True``, inside the AOT envelope's shape (magic + u32
length + u32 crc32), so the JAX package's ``analysis/corpus.py
corrupt_frame_variants`` drives the corruption tests. Check order on read
is aot.py's: integrity (``ArtifactCorrupt``) before key (program
fingerprint, base weights digest: ``ArtifactKeyMismatch``) before the
payload is deserialized; a truncated, bitflipped or transplanted payload
is a typed refusal, never a partially loaded policy.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import tempfile
import time
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.export import aot as aot_lib

__all__ = [
    "STORE_MAGIC",
    "STORE_FORMAT_VERSION",
    "ArtifactStore",
    "ArtifactStoreError",
    "ArtifactCorrupt",
    "ArtifactKeyMismatch",
    "BaseArtifactMissing",
    "PolicyNotFound",
    "PolicyExists",
    "DeltaParityError",
    "program_fingerprint",
    "weights_digest",
]

STORE_FORMAT_VERSION = 1
STORE_MAGIC = b"T2RP"
_HEADER_SIZE = 12  # magic + length + crc32, the corpus frame shape

#: Hard bound on one delta payload; a forged length field is rejected
#: before any allocation happens (corpus frame_huge_length).
MAX_PAYLOAD_BYTES = 1 << 30

_BLOB_DIR = "blobs"
_POLICY_DIR = "policies"

# export/saved_model.py's layout constants (not imported: the store needs
# none of the export machinery).
_VARIABLES_FILENAME = "variables.pt"
_METADATA_FILENAME = "t2r_metadata.json"
_PROGRAM_PREFIX = "program/"


class ArtifactStoreError(RuntimeError):
    """Base class for artifact-store failures."""


class ArtifactCorrupt(ArtifactStoreError):
    """A blob or delta envelope failed integrity (sha/magic/length/CRC/
    deserialize/reconstruction digest): truncated or bitflipped bytes. The
    policy is NOT loaded: there is no partial-decode path."""


class ArtifactKeyMismatch(ArtifactStoreError):
    """The payload is intact but keyed for a different program or base:
    decoding it would materialize the wrong weights under this policy's
    name. Refused loudly, never reinterpreted."""


class BaseArtifactMissing(ArtifactStoreError):
    """A delta payload names a base policy the store does not hold (or no
    longer holds): the sibling cannot be reconstructed."""


class PolicyNotFound(ArtifactStoreError):
    """No manifest under this policy id."""


class PolicyExists(ArtifactStoreError):
    """``put`` refuses to silently overwrite a published policy; delete
    first if the republish is intentional."""


class DeltaParityError(ArtifactStoreError):
    """The encoded payload failed its own round-trip proof during ``put``:
    nothing was written (gate-fails-write-nothing)."""


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _flat_entries(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    """(key path, tensor) of a state dict whose values are tensors or
    nested dicts of them (a weight-quantized export's nodes)."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flat_entries(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def weights_digest(state: Mapping[str, Any]) -> str:
    """sha256 hex of a state dict's canonical form: every tensor, in
    sorted key-path order, as its path, dtype, shape and raw bytes. Equal
    for equal weights whichever file or process wrote them."""
    h = hashlib.sha256()
    for path, tensor in sorted(_flat_entries(state), key=lambda item: item[0]):
        tensor = torch.as_tensor(tensor).detach().cpu().contiguous()
        h.update("/".join(path).encode())
        h.update(f"{tensor.dtype}{list(tensor.shape)}".encode())
        h.update(tensor.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _load_state(data: bytes, what: str) -> Dict[str, Any]:
    try:
        state = torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
    except Exception as err:  # noqa: BLE001 — any refusal of the bytes
        raise ArtifactCorrupt(f"{what}: weights do not load: {err}") from err
    if not isinstance(state, Mapping):
        raise ArtifactCorrupt(f"{what}: weights are not a state dict")
    return state


def _save_state(state: Mapping[str, Any]) -> bytes:
    buffer = io.BytesIO()
    torch.save(dict(state), buffer)
    return buffer.getvalue()


def _flax_table(files: Mapping[str, bytes]) -> Dict[str, Any]:
    try:
        meta = json.loads(files.get(_METADATA_FILENAME, b"{}").decode())
    except (UnicodeDecodeError, ValueError):
        return {}
    table = meta.get("flax_variables") if isinstance(meta, dict) else None
    return table if isinstance(table, dict) else {}


def _leaves(state: Mapping[str, Any], table: Mapping[str, Any]) -> List[Tuple[str, Dict[str, Any], torch.Tensor]]:
    """(flat path, placement, leaf) of every tensor of a state dict: a
    table entry's leaf in the flax layout under its JAX flat path, any
    other under its '/'-joined key path in the torch layout. The placement
    ({"key": key path, "dims": permutation, "index": order}) puts the leaf
    back into the state dict."""
    out = []
    for index, (path, tensor) in enumerate(_flat_entries(state)):
        tensor = torch.as_tensor(tensor).detach().cpu()
        entry = table.get(path[0]) if len(path) == 1 else None
        if entry is not None and len(entry[1]) == tensor.ndim:
            flax_path, dims = entry[0], [int(d) for d in entry[1]]
            inverse = sorted(range(len(dims)), key=dims.__getitem__)
            leaf = tensor.permute(*inverse).contiguous() if dims else tensor
        else:
            flax_path, dims, leaf = "/".join(path), None, tensor
        out.append((flax_path, {"key": list(path), "dims": dims, "index": index}, leaf))
    return out


def _restore_state(placed: Mapping[str, Tuple[Mapping[str, Any], torch.Tensor]]) -> Dict[str, Any]:
    """The state dict of leaves placed by `_leaves` (in their order)."""
    state: Dict[str, Any] = {}
    for placement, leaf in sorted(placed.values(), key=lambda item: item[0]["index"]):
        dims = placement["dims"]
        tensor = leaf.permute(*dims).contiguous() if dims else leaf
        node = state
        *parents, last = placement["key"]
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = tensor
    return state


def program_fingerprint(files: Mapping[str, bytes]) -> str:
    """Hex fingerprint of an export's PROGRAM identity: sha256 over the
    serving programs' bytes (``program/``), path-labelled, by the same
    chained-digest construction as the AOT fingerprint (the JAX store
    reads ``stablehlo/``). Two exports are siblings (delta-eligible) iff
    these match. An export with no program falls back to every
    non-weight file, so the key still pins content identity."""
    program = sorted(rel for rel in files if rel.startswith(_PROGRAM_PREFIX)
                     or rel.startswith("program" + os.sep))
    if not program:
        program = sorted(
            rel for rel in files
            if rel != _VARIABLES_FILENAME
            and not rel.startswith("quant/") and not rel.startswith("quant" + os.sep)
            and not rel.startswith("aot/") and not rel.startswith("aot" + os.sep))
    chunks: List[bytes] = []
    for rel in program:
        chunks.append(aot_lib.digest(rel.replace(os.sep, "/").encode()))
        chunks.append(aot_lib.digest(files[rel]))
    return aot_lib.artifact_fingerprint("store", chunks)


def _pack(header: Dict[str, Any], payload: bytes) -> bytes:
    header_bytes = json.dumps(header, sort_keys=True).encode()
    rest = struct.pack("<I", len(header_bytes)) + header_bytes + payload
    return (
        STORE_MAGIC
        + struct.pack("<I", len(rest))
        + struct.pack("<I", zlib.crc32(rest) & 0xFFFFFFFF)
        + rest
    )


def _unpack(blob: bytes) -> Tuple[Dict[str, Any], bytes]:
    """Envelope -> (header, serialized leaves); integrity only, no keys."""
    if len(blob) < _HEADER_SIZE:
        raise ArtifactCorrupt(f"delta payload truncated at {len(blob)} bytes")
    if blob[:4] != STORE_MAGIC:
        raise ArtifactCorrupt(f"bad magic {blob[:4]!r} (want {STORE_MAGIC!r})")
    (length,) = struct.unpack("<I", blob[4:8])
    (crc,) = struct.unpack("<I", blob[8:12])
    if length > MAX_PAYLOAD_BYTES:
        raise ArtifactCorrupt(f"forged length {length} exceeds the format bound")
    rest = blob[_HEADER_SIZE:]
    if len(rest) != length:
        raise ArtifactCorrupt(
            f"length field says {length} bytes, file carries {len(rest)}")
    if zlib.crc32(rest) & 0xFFFFFFFF != crc:
        raise ArtifactCorrupt("crc mismatch: delta payload is corrupt")
    if len(rest) < 4:
        raise ArtifactCorrupt("envelope too short for a header")
    (hlen,) = struct.unpack("<I", rest[:4])
    if hlen > len(rest) - 4:
        raise ArtifactCorrupt(f"header length {hlen} overruns the envelope")
    try:
        header = json.loads(rest[4 : 4 + hlen].decode())
    except (UnicodeDecodeError, ValueError) as err:
        raise ArtifactCorrupt(f"header is not JSON: {err}") from err
    if not isinstance(header, dict):
        raise ArtifactCorrupt("header is not a JSON object")
    return header, rest[4 + hlen :]


def _delta_tolerance() -> float:
    raw = flags.get_str("T2R_POLICY_DELTA_TOL")
    try:
        tol = float(raw)
    except (TypeError, ValueError) as err:
        raise ValueError(f"T2R_POLICY_DELTA_TOL={raw!r} is not a float") from err
    if tol < 0:
        raise ValueError(f"T2R_POLICY_DELTA_TOL={raw!r} is negative")
    return tol


def _encode_leaf_delta(diff: torch.Tensor, regime: str, block: int) -> Dict[str, torch.Tensor]:
    """One leaf's raveled diff through the collective codec: the codec's
    block view needs the last dim to divide by the block, so the diff
    ravels and zero-pads; padded tail elements decode to zero and are
    sliced off."""
    from tensor2robot_tpu_torch.parallel import collectives

    collective = collectives.get_collective(regime, block)
    flat = diff.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return dict(collective.encode(flat.reshape(1, -1)))


def _decode_leaf_delta(payload: Mapping[str, torch.Tensor], regime: str, block: int,
                       size: int) -> torch.Tensor:
    from tensor2robot_tpu_torch.parallel import collectives

    collective = collectives.get_collective(regime, block)
    return collective.decode(dict(payload)).to(torch.float32).reshape(-1)[:size]


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _dtype_name(tensor: torch.Tensor) -> str:
    return str(tensor.dtype).rsplit(".", 1)[-1]


class ArtifactStore:
    """Content-addressed export store with delta-compressed siblings.

    Writes go to temp files in the store root and land via ``os.replace``;
    the manifest lands LAST, so a policy either exists completely or not
    at all (a crashed ``put`` leaves only unreferenced blobs, which a
    later identical ``put`` adopts)."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(os.path.join(self.root, _BLOB_DIR), exist_ok=True)
        os.makedirs(os.path.join(self.root, _POLICY_DIR), exist_ok=True)

    # -- paths -------------------------------------------------------------

    def _blob_path(self, sha: str) -> str:
        return os.path.join(self.root, _BLOB_DIR, f"sha256-{sha}")

    def _manifest_path(self, policy_id: str) -> str:
        return os.path.join(self.root, _POLICY_DIR, f"{policy_id}.json")

    @staticmethod
    def _check_policy_id(policy_id: str) -> str:
        if not policy_id or not all(c.isalnum() or c in "._-" for c in policy_id):
            raise ValueError(
                f"policy id {policy_id!r} must be non-empty "
                "[A-Za-z0-9._-] (it names a manifest file)")
        return policy_id

    # -- queries -----------------------------------------------------------

    def has(self, policy_id: str) -> bool:
        return os.path.exists(self._manifest_path(policy_id))

    def policies(self) -> List[str]:
        pdir = os.path.join(self.root, _POLICY_DIR)
        return sorted(name[: -len(".json")] for name in os.listdir(pdir)
                      if name.endswith(".json"))

    def manifest(self, policy_id: str) -> Dict[str, Any]:
        path = self._manifest_path(policy_id)
        if not os.path.exists(path):
            raise PolicyNotFound(
                f"no policy {policy_id!r} in store {self.root} "
                f"(have: {', '.join(self.policies()) or 'none'})")
        with open(path, "rb") as f:
            return json.loads(f.read().decode())

    def stats(self) -> Dict[str, Any]:
        """Disk accounting: store bytes (blobs + manifests) vs the dense
        bytes the same policies would cost stored as full export dirs."""
        blob_dir = os.path.join(self.root, _BLOB_DIR)
        blob_bytes = n_blobs = 0
        for name in os.listdir(blob_dir):
            blob_bytes += os.path.getsize(os.path.join(blob_dir, name))
            n_blobs += 1
        manifest_bytes = dense_bytes = n_delta = 0
        ids = self.policies()
        for policy_id in ids:
            manifest_bytes += os.path.getsize(self._manifest_path(policy_id))
            man = self.manifest(policy_id)
            dense_bytes += int(man.get("export_nbytes", 0))
            if man["payload"]["kind"] == "delta":
                n_delta += 1
        return {
            "n_policies": len(ids),
            "n_delta_policies": n_delta,
            "n_blobs": n_blobs,
            "blob_bytes": blob_bytes,
            "manifest_bytes": manifest_bytes,
            "store_bytes": blob_bytes + manifest_bytes,
            "dense_bytes": dense_bytes,
        }

    # -- write path --------------------------------------------------------

    def _write_file(self, directory: str, final: str, data: bytes) -> None:
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, final)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _write_blob(self, data: bytes) -> str:
        sha = _sha256_hex(data)
        path = self._blob_path(sha)
        if not os.path.exists(path):  # content-addressed: one blob
            self._write_file(os.path.join(self.root, _BLOB_DIR), path, data)
        return sha

    def _read_blob(self, sha: str, what: str) -> bytes:
        path = self._blob_path(sha)
        if not os.path.exists(path):
            raise ArtifactCorrupt(f"{what}: blob sha256-{sha} missing from the store")
        with open(path, "rb") as f:
            data = f.read()
        if _sha256_hex(data) != sha:
            raise ArtifactCorrupt(
                f"{what}: blob sha256-{sha} fails its content hash "
                "(bytes on disk are corrupt)")
        return data

    def put(
        self,
        export_dir: str,
        policy_id: str,
        base_policy: Optional[str] = None,
        *,
        regime: Optional[str] = None,
        block: Optional[int] = None,
        tolerance: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Store one export dir under ``policy_id``.

        With ``base_policy`` the weights store as a quantized per-leaf
        delta against that base (which must hold the SAME program
        fingerprint: a cross-program delta is refused typed). Every
        encoded payload proves its own round trip before anything is
        written; the manifest lands last, atomically."""
        self._check_policy_id(policy_id)
        if self.has(policy_id):
            raise PolicyExists(f"policy {policy_id!r} already published in {self.root}")
        if regime is None:
            regime = flags.get_enum("T2R_POLICY_DELTA_QUANT")
        if block is None:
            block = flags.get_int("T2R_POLICY_DELTA_BLOCK")
        if tolerance is None:
            tolerance = _delta_tolerance()

        files: Dict[str, bytes] = {}
        for dirpath, _, names in os.walk(export_dir):
            for name in names:
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, export_dir).replace(os.sep, "/")
                with open(full, "rb") as f:
                    files[rel] = f.read()
        if _VARIABLES_FILENAME not in files:
            raise ArtifactStoreError(
                f"{export_dir} has no {_VARIABLES_FILENAME}: not an export dir")
        fingerprint = program_fingerprint(files)
        export_nbytes = sum(len(v) for v in files.values())
        variables_bytes = files[_VARIABLES_FILENAME]
        state = _load_state(variables_bytes, f"put({policy_id})")

        envelope: Optional[bytes] = None
        if base_policy is None:
            payload_entry: Dict[str, Any] = {
                "kind": "dense",
                "blob": _sha256_hex(variables_bytes),
                "nbytes": len(variables_bytes),
                "base": None,
                "weights_sha": weights_digest(state),
                "weights_nbytes": len(variables_bytes),
            }
        else:
            envelope, payload_entry = self._build_delta(
                policy_id, base_policy, fingerprint, state, _flax_table(files),
                regime=regime, block=block, tolerance=tolerance)
            # Round-trip proof BEFORE any write: the payload about to be
            # published must decode back to the recorded weights digest.
            reconstructed = self._decode_envelope(
                envelope, expect_fingerprint=fingerprint,
                base_state=self._load_state(base_policy), what=f"put({policy_id})")
            if weights_digest(reconstructed) != payload_entry["weights_sha"]:
                raise DeltaParityError(
                    f"policy {policy_id!r}: encoded delta payload does not "
                    "round-trip to its recorded weights digest; nothing was "
                    "written")

        stored_files: Dict[str, Dict[str, Any]] = {}
        for rel, data in sorted(files.items()):
            if rel == _VARIABLES_FILENAME and base_policy is not None:
                continue  # replaced by the delta payload
            stored_files[rel] = {"blob": self._write_blob(data), "nbytes": len(data)}
        if envelope is not None:
            payload_entry["blob"] = self._write_blob(envelope)
            payload_entry["nbytes"] = len(envelope)

        manifest = {
            "store_version": STORE_FORMAT_VERSION,
            "policy_id": policy_id,
            "fingerprint": fingerprint,
            "files": stored_files,
            "payload": payload_entry,
            "export_nbytes": export_nbytes,
        }
        self._write_file(os.path.join(self.root, _POLICY_DIR),
                         self._manifest_path(policy_id),
                         json.dumps(manifest, sort_keys=True, indent=1).encode())
        return manifest

    def _build_delta(
        self,
        policy_id: str,
        base_policy: str,
        fingerprint: str,
        state: Mapping[str, Any],
        table: Mapping[str, Any],
        *,
        regime: str,
        block: int,
        tolerance: float,
    ) -> Tuple[bytes, Dict[str, Any]]:
        if not self.has(base_policy):
            raise BaseArtifactMissing(
                f"policy {policy_id!r} names base {base_policy!r}, which "
                f"store {self.root} does not hold")
        base_manifest = self.manifest(base_policy)
        if base_manifest["fingerprint"] != fingerprint:
            raise ArtifactKeyMismatch(
                f"policy {policy_id!r} (program {fingerprint[:12]}…) is not a "
                f"sibling of base {base_policy!r} (program "
                f"{base_manifest['fingerprint'][:12]}…): a delta across "
                "programs would decode garbage weights")
        base_leaves = {path: leaf for path, _, leaf in
                       _leaves(self._load_state(base_policy), table)}

        leaf_meta: Dict[str, Dict[str, Any]] = {}
        leaf_payload: Dict[str, Any] = {}
        reconstructed: Dict[str, Tuple[Dict[str, Any], torch.Tensor]] = {}
        n_delta = 0
        for path, placement, leaf in _leaves(state, table):
            base_leaf = base_leaves.get(path)
            eligible = (base_leaf is not None and base_leaf.shape == leaf.shape
                        and leaf.is_floating_point() and regime != "none")
            if eligible:
                base_f32 = base_leaf.to(torch.float32)
                encoded = _encode_leaf_delta(leaf.to(torch.float32) - base_f32, regime, block)
                decoded = _decode_leaf_delta(encoded, regime, block, leaf.numel())
                recon = (base_f32.reshape(-1) + decoded).reshape(leaf.shape).to(leaf.dtype)
                scale = max(float(leaf.abs().max()) if leaf.numel() else 0.0, 1e-8)
                err = float((recon.to(torch.float32) - leaf).abs().max()) if leaf.numel() else 0.0
                if err <= tolerance * scale:
                    leaf_meta[path] = {"enc": "delta", "shape": list(leaf.shape),
                                       "dtype": _dtype_name(leaf), "max_abs_err": err,
                                       **placement}
                    leaf_payload[path] = encoded
                    reconstructed[path] = (placement, recon)
                    n_delta += 1
                    continue
            # Parity gate failed (or the leaf is new, reshaped or not
            # float): THIS LEAF ships dense-exact; the policy publishes.
            leaf_meta[path] = {"enc": "dense", "shape": list(leaf.shape),
                               "dtype": _dtype_name(leaf), **placement}
            leaf_payload[path] = leaf.contiguous()
            reconstructed[path] = (placement, leaf)

        recon_state = _restore_state(reconstructed)
        header = {
            "format_version": STORE_FORMAT_VERSION,
            "kind": "delta",
            "policy_id": policy_id,
            "base": base_policy,
            "fingerprint": fingerprint,
            "base_weights_sha": base_manifest["payload"]["weights_sha"],
            "weights_sha": weights_digest(recon_state),
            "regime": regime,
            "block": int(block),
            "tolerance": float(tolerance),
            "leaves": leaf_meta,
        }
        envelope = _pack(header, _save_state(leaf_payload))
        entry = {
            "kind": "delta",
            "base": base_policy,
            "weights_sha": header["weights_sha"],
            "weights_nbytes": len(_save_state(recon_state)),
            "regime": regime,
            "block": int(block),
            "tolerance": float(tolerance),
            "leaves": {"total": len(leaf_meta), "delta": n_delta,
                       "dense": len(leaf_meta) - n_delta},
        }
        return envelope, entry

    # -- read path ---------------------------------------------------------

    def _decode_envelope(
        self,
        envelope: bytes,
        *,
        expect_fingerprint: str,
        base_state: Mapping[str, Any],
        what: str,
    ) -> Dict[str, Any]:
        """The delta read path over in-memory bytes: integrity, then key,
        then decode and reassembly. Returns the reconstructed state dict
        (NOT yet digest-verified: callers compare against the manifest's
        weights_sha, so corruption and key errors stay distinct)."""
        header, payload = _unpack(envelope)
        if header.get("format_version") != STORE_FORMAT_VERSION:
            raise ArtifactKeyMismatch(
                f"{what}: payload format_version {header.get('format_version')} "
                f"!= {STORE_FORMAT_VERSION}")
        if header.get("fingerprint") != expect_fingerprint:
            raise ArtifactKeyMismatch(
                f"{what}: delta payload is keyed to program "
                f"{str(header.get('fingerprint'))[:12]}…, this policy serves "
                f"{expect_fingerprint[:12]}…")
        if header.get("base_weights_sha") != weights_digest(base_state):
            raise ArtifactKeyMismatch(
                f"{what}: base weights changed since this delta was encoded "
                "(base_weights_sha mismatch): decoding against the wrong base "
                "would materialize garbage")
        try:
            leaf_payload = torch.load(io.BytesIO(payload), map_location="cpu",
                                      weights_only=True)
            if not isinstance(leaf_payload, dict):
                raise ValueError("payload is not a leaf dict")
        except Exception as err:  # noqa: BLE001 — any refusal of the bytes
            raise ArtifactCorrupt(f"{what}: delta payload does not load: {err}") from err
        regime = header.get("regime")
        block = int(header.get("block", 0) or 0)
        leaves_meta = header.get("leaves") or {}
        reconstructed: Dict[str, Tuple[Dict[str, Any], torch.Tensor]] = {}
        try:
            table = {meta["key"][0]: [path, meta["dims"]]
                     for path, meta in leaves_meta.items() if meta.get("dims") is not None}
            base_leaves = {path: leaf for path, _, leaf in _leaves(base_state, table)}
            for path, meta in leaves_meta.items():
                entry = leaf_payload[path]
                shape = tuple(int(d) for d in meta["shape"])
                dtype = _dtype(meta["dtype"])
                placement = {"key": [str(k) for k in meta["key"]], "dims": meta["dims"],
                             "index": int(meta["index"])}
                if meta["enc"] == "dense":
                    if (not isinstance(entry, torch.Tensor) or tuple(entry.shape) != shape
                            or entry.dtype != dtype):
                        raise ArtifactCorrupt(
                            f"{what}: dense leaf {path!r} shape/dtype disagrees "
                            "with its header")
                    reconstructed[path] = (placement, entry)
                    continue
                base_leaf = base_leaves.get(path)
                if base_leaf is None:
                    raise ArtifactKeyMismatch(f"{what}: delta leaf {path!r} has no base leaf")
                size = 1
                for d in shape:
                    size *= d
                decoded = _decode_leaf_delta(entry, regime, block, size)
                reconstructed[path] = (placement, (
                    base_leaf.to(torch.float32).reshape(-1) + decoded).reshape(shape).to(dtype))
        except (KeyError, TypeError, ValueError, RuntimeError, AttributeError,
                IndexError) as err:
            if isinstance(err, ArtifactStoreError):
                raise
            raise ArtifactCorrupt(f"{what}: delta payload leaves are malformed: {err}") from err
        return _restore_state(reconstructed)

    def _load_state(self, policy_id: str) -> Dict[str, Any]:
        """The policy's weights as a state dict, delta-decoded and
        digest-verified."""
        manifest = self.manifest(policy_id)
        payload = manifest["payload"]
        if payload["kind"] == "dense":
            data = self._read_blob(payload["blob"], f"policy {policy_id!r} dense weights")
            return _load_state(data, f"policy {policy_id!r}")
        base = payload["base"]
        if not self.has(base):
            raise BaseArtifactMissing(
                f"policy {policy_id!r} delta-references base {base!r}, which "
                f"store {self.root} no longer holds")
        envelope = self._read_blob(payload["blob"], f"policy {policy_id!r} delta payload")
        state = self._decode_envelope(
            envelope, expect_fingerprint=manifest["fingerprint"],
            base_state=self._load_state(base), what=f"policy {policy_id!r}")
        if weights_digest(state) != payload["weights_sha"]:
            raise ArtifactCorrupt(
                f"policy {policy_id!r}: reconstructed weights fail their "
                "recorded digest; refusing the partial or garbled state")
        return state

    def load_weights(self, policy_id: str) -> bytes:
        """The policy's variables.pt bytes, delta-decoded and verified
        against the manifest (a dense base's are its stored bytes)."""
        manifest = self.manifest(policy_id)
        if manifest["payload"]["kind"] == "dense":
            return self._read_blob(manifest["payload"]["blob"],
                                   f"policy {policy_id!r} dense weights")
        return _save_state(self._load_state(policy_id))

    def materialize(self, policy_id: str, dest_dir: str) -> str:
        """Reconstruct the full export dir under ``dest_dir``.

        Every file lands from a sha-verified blob; the weights go through
        the delta read path. Written via a temp dir + rename, so a crashed
        materialize never looks like an export."""
        manifest = self.manifest(policy_id)
        weights = self.load_weights(policy_id)
        parent = os.path.dirname(os.path.abspath(dest_dir)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=parent, prefix=".materialize-")
        try:
            for rel, entry in manifest["files"].items():
                data = self._read_blob(entry["blob"], f"policy {policy_id!r} file {rel!r}")
                full = os.path.join(tmp, rel.replace("/", os.sep))
                os.makedirs(os.path.dirname(full), exist_ok=True)
                with open(full, "wb") as f:
                    f.write(data)
            with open(os.path.join(tmp, _VARIABLES_FILENAME), "wb") as f:
                f.write(weights)
            if os.path.exists(dest_dir):
                raise ArtifactStoreError(f"materialize: {dest_dir} already exists")
            os.replace(tmp, dest_dir)
        except BaseException:
            if os.path.exists(tmp):
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
            raise
        return dest_dir

    def delete(self, policy_id: str) -> None:
        """Drop a policy's manifest (blobs stay: other policies may
        reference them; ``gc`` sweeps the orphans)."""
        path = self._manifest_path(policy_id)
        if not os.path.exists(path):
            raise PolicyNotFound(f"no policy {policy_id!r} to delete")
        os.unlink(path)

    def _mark_live(self, policy_id: str, live: set, seen: set,
                   missing_ok: bool = False) -> None:
        """Adds every blob reachable from `policy_id` (its file table, its
        payload and, transitively, its delta base chain) to `live`. A
        manifest that exists but does not PARSE is a typed refusal:
        sweeping against a torn mark set would delete blobs a repaired
        manifest still needs."""
        if policy_id in seen:
            return
        seen.add(policy_id)
        try:
            manifest = self.manifest(policy_id)
        except PolicyNotFound:
            if missing_ok:  # deleted between listing and read
                return
            raise
        except ValueError as err:  # json decode failure
            raise ArtifactCorrupt(
                f"gc refused: manifest for {policy_id!r} does not parse "
                f"({err}) — repair or delete it before sweeping") from err
        try:
            for entry in manifest["files"].values():
                live.add(entry["blob"])
            payload = manifest["payload"]
            if payload.get("blob"):
                live.add(payload["blob"])
            base = payload.get("base")
        except (KeyError, TypeError, AttributeError) as err:
            raise ArtifactCorrupt(
                f"gc refused: manifest for {policy_id!r} is missing required "
                f"fields ({err}) — repair or delete it before sweeping") from err
        if base:
            self._mark_live(base, live, seen, missing_ok=missing_ok)

    def gc(self, roots: Optional[List[str]] = None, *, dry_run: bool = False,
           grace_s: float = 600.0) -> Dict[str, Any]:
        """Mark-and-sweep collection of orphaned blobs.

        Mark: every blob reachable from `roots` (policy ids; default every
        manifest in the store) through file tables, payloads and
        transitive delta-base chains; an explicit subset declares the rest
        dead. A root manifest that fails to parse aborts the sweep with a
        typed ``ArtifactCorrupt``. Sweep honors manifests-land-last, so a
        CONCURRENT put is never torn: blobs younger than `grace_s` are
        kept, manifests that landed between mark and sweep are re-marked,
        and in-progress temp files (``.tmp-*``) are never candidates.

        Returns counts: scanned/live/deleted/bytes_freed/kept_young, with
        `deleted` counting would-be deletions under `dry_run`."""
        blob_dir = os.path.join(self.root, _BLOB_DIR)
        live: set = set()
        seen: set = set()
        initial = set(self.policies())
        root_ids = sorted(initial) if roots is None else list(roots)
        for policy_id in root_ids:
            self._mark_live(policy_id, live, seen, missing_ok=roots is None)
        now = time.time()
        scanned = kept_young = 0
        candidates: List[Tuple[str, str, int]] = []
        names = sorted(os.listdir(blob_dir)) if os.path.isdir(blob_dir) else []
        for name in names:
            if not name.startswith("sha256-"):
                continue  # .tmp-* in-flight writes are never candidates
            scanned += 1
            sha = name[len("sha256-"):]
            if sha in live:
                continue
            path = os.path.join(blob_dir, name)
            try:
                stat = os.stat(path)
            except OSError:
                continue  # raced another collector
            if now - stat.st_mtime < grace_s:
                kept_young += 1
                continue
            candidates.append((sha, path, stat.st_size))
        if candidates:
            # A manifest that appeared after the mark began may reference
            # candidate blobs (its put wrote blobs first): re-mark only new
            # arrivals; manifests the caller chose not to root stay dead.
            for policy_id in self.policies():
                if policy_id not in initial and policy_id not in seen:
                    self._mark_live(policy_id, live, seen, missing_ok=True)
            candidates = [c for c in candidates if c[0] not in live]
        deleted = bytes_freed = 0
        for _sha, path, size in candidates:
            if not dry_run:
                try:
                    os.unlink(path)
                except OSError:
                    continue  # raced another collector; not counted
            deleted += 1
            bytes_freed += size
        return {
            "scanned": scanned,
            "live": len(live),
            "deleted": deleted,
            "bytes_freed": bytes_freed,
            "kept_young": kept_young,
            "dry_run": dry_run,
        }
