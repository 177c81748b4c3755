"""Dataset assembly: files -> interleave -> shuffle -> batch -> parse -> prefetch.

Port of tensor2robot_tpu/data/dataset.py: the host reads records, parses
them and decodes images; the crops, distortions and casts run on the card
inside the train step (the critic's preprocessor), so uint8 images stay
uint8 until the card. The same seed gives the JAX package's batches:

  * file-pattern listing, and per-epoch file shuffling in training, from
    `random.Random(seed)`;
  * cyclic interleave across files, a record-level shuffle buffer;
  * batches of `batch_size` with drop_remainder;
  * a multi-dataset zip keyed by dataset_key;
  * decode-time ROI offsets from `np.random.default_rng(seed)`;
  * parallel parsing in a thread or a spawned process pool, and a
    background prefetch.

Where a card is visible, the thread backend parses uint8 image fields
straight into pinned buffers from a `PinnedRing` (train/infeed.py), which
the infeed copies without another host copy. Where the JPEG codec runs on the card (nvJPEG), process
workers do not decode: they return the encoded images and the parent
decodes them (`FastSpecParser.finish`), since a worker must not touch
CUDA. `shard_by_host` splits the files round-robin by `data_shard`, the
(index, count) of this rank's data x fsdp shard of a mesh
(parallel/mesh.data_shard), so the sequence and expert ranks of one data
replica read the same records; without one it takes the
`torch.distributed` rank and world size, or 0 and 1 when no process group
is set up. Each sharded stream then batches `batch_size / count` records:
the global batch, the shards' batches concatenated in shard order, keeps
the size of the single-device batch. The JAX package has no multi-host
batch assembly to copy (its `shard_batch` places each host's batch as
global), so this is the port's definition.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import logging
import os
import pickle
import queue
import random
import threading
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.data import codec, tfrecord
from tensor2robot_tpu_torch.data.parser import SpecParser
from tensor2robot_tpu_torch.data.roi import (
    DecodeROI,
    normalize_decode_rois,
    resolve_decode_rois,
)
from tensor2robot_tpu_torch.data.wire import (
    DeferredImages,
    FastSpecParser,
    default_decode_cache_mb,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.train.infeed import PinnedRing

_log = logging.getLogger(__name__)


def _interleave_files(
    files: Sequence[str],
    cycle_length: int,
    shuffle_files: bool,
    rng: Optional[random.Random],
    repeat: bool,
) -> Iterator[bytes]:
    """Round-robin record interleave across up to `cycle_length` open files."""
    while True:
        order = list(files)
        if shuffle_files and rng is not None:
            rng.shuffle(order)
        pending = iter(order)
        active: List[Iterator[bytes]] = [
            tfrecord.read_tfrecords(path)
            for path in itertools.islice(pending, cycle_length)
        ]
        while active:
            next_active: List[Iterator[bytes]] = []
            for reader in active:
                try:
                    yield next(reader)
                    next_active.append(reader)
                except StopIteration:
                    try:
                        next_active.append(tfrecord.read_tfrecords(next(pending)))
                    except StopIteration:
                        pass
            active = next_active
        if not repeat:
            return


def _shuffle_records(records: Iterator, buffer_size: int, rng: random.Random) -> Iterator:
    buf: List = []
    for record in records:
        buf.append(record)
        if len(buf) >= buffer_size:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


class _Prefetcher:
    """Bounded background-thread prefetch queue.

    The producer re-checks a stop flag between bounded put attempts, so a
    consumer that stops early releases the thread and its buffers:
    `__iter__` returns a handle whose collection closes the prefetcher.
    """

    _SENTINEL = object()

    def __init__(self, source: Iterator, depth: int):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._fill, args=(source,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stopped.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self, source: Iterator) -> None:
        try:
            for item in source:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — handed to the consumer
            self._error = e
        finally:
            self._put(self._SENTINEL)

    def close(self) -> None:
        self._stopped.set()
        # Drain so a producer blocked in put() sees the stop flag.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def get(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def __iter__(self) -> "_PrefetchIterator":
        return _PrefetchIterator(self)


class _PrefetchIterator:
    """The consumer's end of a _Prefetcher; dropping it stops the producer
    (the producer thread holds the prefetcher, never this handle)."""

    def __init__(self, prefetcher: _Prefetcher):
        self._prefetcher = prefetcher

    def __iter__(self) -> "_PrefetchIterator":
        return self

    def __next__(self):
        return self._prefetcher.get()

    def __del__(self):
        self._prefetcher.close()


def default_parse_workers() -> int:
    """Parse parallelism: T2R_PARSE_WORKERS, else one worker per core up to
    8; 0 parses synchronously."""
    env = flags.get_optional_int("T2R_PARSE_WORKERS")
    if env is not None:
        return env
    return min(8, os.cpu_count() or 1)


def default_parse_backend() -> str:
    """'thread' (default) or 'process' (T2R_PARSE_BACKEND). The codec and
    the record indexer release the GIL, but each parse holds it for its
    Python and numpy glue; spawned processes avoid that ceiling and ship
    parsed batches back through a shared-memory ring."""
    return flags.get_enum("T2R_PARSE_BACKEND")


def default_parse_fast() -> bool:
    """Whether the wire-format fast parser runs first (T2R_PARSE_FAST)."""
    return flags.get_bool("T2R_PARSE_FAST")


def default_decode_roi() -> bool:
    """Whether decode-time ROI crops are honored (T2R_DECODE_ROI); 0 makes
    RecordDataset decode full frames and the consumer crop."""
    return flags.get_bool("T2R_DECODE_ROI")


def default_parse_shm() -> bool:
    """Whether process workers return batches through shared memory
    (T2R_PARSE_SHM); 0 pickles them through the result pipe."""
    return flags.get_bool("T2R_PARSE_SHM")


def default_parse_on_error() -> str:
    """T2R_PARSE_ON_ERROR: 'raise' (default) ends the stream on a corrupt
    record; 'skip' drops and counts it."""
    return flags.get_enum("T2R_PARSE_ON_ERROR")


class _FastParseState:
    """A FastSpecParser and its fallback accounting. After `max_fallbacks`
    failed batches the fast path is switched off: persistent fallback
    means the data disagrees with the compiled schema."""

    max_fallbacks = 8

    def __init__(self, specs, enabled: bool):
        self.parser: Optional[FastSpecParser] = None
        if enabled:
            fast = FastSpecParser(specs)
            if fast.supported:
                self.parser = fast
            else:
                _log.info("fast parser disabled for this spec structure: %s",
                          fast.unsupported_reason)

    def note_fallback(self) -> None:
        parser = self.parser
        if parser is None:
            return
        parser.fallbacks += 1
        if parser.fallbacks == 1:
            _log.warning("fast parse failed for a batch; re-parsing with SpecParser")
        if parser.fallbacks >= self.max_fallbacks:
            _log.warning("fast parser disabled after %d fallbacks", parser.fallbacks)
            self.parser = None


class ParseStats:
    """Degradation counters one dataset's consumers share (thread-safe):
    records dropped under T2R_PARSE_ON_ERROR=skip, the batches that lost
    records or were dropped whole, and process workers' fast-parser
    fallbacks. Surfaced by RecordDataset.stats()."""

    _FIELDS = ("records_skipped", "batches_degraded", "batches_dropped",
               "fast_fallbacks")
    __slots__ = ("_lock",) + _FIELDS

    def __init__(self):
        self._lock = threading.Lock()
        for field in self._FIELDS:
            setattr(self, field, 0)

    def note_skipped(self, records: int, whole_batch: bool) -> None:
        with self._lock:
            self.records_skipped += records
            if whole_batch:
                self.batches_dropped += 1
            else:
                self.batches_degraded += 1

    def merge(self, delta: Dict[str, int]) -> None:
        """Folds a worker's per-chunk delta into these totals."""
        with self._lock:
            for field in self._FIELDS:
                setattr(self, field, getattr(self, field) + delta.get(field, 0))

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {field: getattr(self, field) for field in self._FIELDS}


def _regroup_chunk(chunk):
    """Multi-dataset chunks arrive as per-record dicts; both parsers take
    {dataset_key: [record, ...]} columns."""
    if isinstance(chunk[0], dict):
        return {k: [row[k] for row in chunk] for k in chunk[0].keys()}
    return chunk


def _split_payload(payload):
    """A parse payload is a chunk, or ("roi", chunk, {key: ResolvedROI})
    with the offsets resolved once in the parent, so every parser of the
    chunk crops alike."""
    if isinstance(payload, tuple) and len(payload) == 3 and payload[0] == "roi":
        return payload[1], payload[2]
    return payload, None


def _slice_roi(roi, keep: List[int]):
    """Per-record ROI offsets restricted to the surviving records."""
    if roi is None:
        return None
    return {
        key: dataclasses.replace(resolved, ys=np.asarray(resolved.ys)[keep],
                                 xs=np.asarray(resolved.xs)[keep])
        for key, resolved in roi.items()
    }


def _skip_and_parse(parser: SpecParser, chunk, roi, stats: Optional[ParseStats],
                    original_error: BaseException) -> Optional[TensorSpecStruct]:
    """T2R_PARSE_ON_ERROR=skip: triage the failed batch record by record
    with the oracle, drop (and count) the corrupt ones, parse the rest.
    None when nothing survives. When every record parses alone, the
    failure was batch-level, not record corruption: it re-raises."""
    keep: List[int] = []
    for index, record in enumerate(chunk):
        try:
            parser.parse_single(record)
        except Exception:  # noqa: BLE001 — the record is the one being triaged
            continue
        keep.append(index)
    skipped = len(chunk) - len(keep)
    if skipped == 0:
        raise original_error
    if stats is not None:
        stats.note_skipped(skipped, whole_batch=not keep)
    _log.warning("T2R_PARSE_ON_ERROR=skip: dropped %d corrupt record(s) from "
                 "a batch of %d", skipped, len(chunk))
    if not keep:
        return None
    survivors = [chunk[index] for index in keep]
    return parser.parse_batch(_regroup_chunk(survivors), roi=_slice_roi(roi, keep))


def _parse_chunk_impl(fast_state: Optional[_FastParseState], parser: SpecParser,
                      payload, stats: Optional[ParseStats] = None,
                      alloc=None) -> Optional[TensorSpecStruct]:
    """Fast wire-format parse, re-parsed with SpecParser (same ROI offsets)
    on any fast-path failure: bad data then raises the oracle's error, a
    fast-path limitation costs time only. Under T2R_PARSE_ON_ERROR=skip an
    oracle failure triages per record (None when nothing survives)."""
    chunk, roi = _split_payload(payload)
    fast = fast_state.parser if fast_state is not None else None
    if fast is not None:
        try:
            return fast.parse_batch(_regroup_chunk(chunk), roi=roi, alloc=alloc)
        except Exception:  # noqa: BLE001 — any fast-path failure falls back
            fast_state.note_fallback()
    try:
        return parser.parse_batch(_regroup_chunk(chunk), roi=roi)
    except Exception as err:  # noqa: BLE001 — classified by the error mode
        if default_parse_on_error() != "skip":
            raise
        return _skip_and_parse(parser, chunk, roi, stats, err)


# -- the process backend --------------------------------------------------------

# Per-process parse state of a pool worker, set by its initializer, so
# submitted jobs reach it without pickling the parser per chunk.
_PROCESS_PARSER: Optional[SpecParser] = None
_PROCESS_FAST: Optional[_FastParseState] = None
_PROCESS_SHM_FREE = None  # free-slot name queue, or None (inline returns)
_PROCESS_SHM_CACHE: Dict[str, Any] = {}  # name -> attached SharedMemory
_PROCESS_DEFER = False  # leave image decoding to the parent (card codec)

# Arrays below this size ride the result pipe; shm slots are for the large
# decoded image batches, where pickling is the dominant IPC cost.
_SHM_MIN_SHIP_BYTES = 1 << 20
_SHM_ALIGN = 64
_SHM_DIR = "/dev/shm"


def _process_pool_init(specs_blob: bytes, parse_fast: bool, shm_free,
                       decode_cache_mb: int, defer_images: bool) -> None:
    global _PROCESS_PARSER, _PROCESS_FAST, _PROCESS_SHM_FREE, _PROCESS_DEFER
    specs = pickle.loads(specs_blob)  # written by this program's parent
    _PROCESS_PARSER = SpecParser(specs)
    _PROCESS_FAST = _FastParseState(specs, parse_fast)
    _PROCESS_SHM_FREE = shm_free
    _PROCESS_DEFER = defer_images
    # Each worker gets its share of the decode-cache budget.
    flags.write_env("T2R_DECODE_CACHE_MB", decode_cache_mb)


def _shm_attach(name: str):
    shm = _PROCESS_SHM_CACHE.get(name)
    if shm is None:
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        _PROCESS_SHM_CACHE[name] = shm
    return shm


def _shm_align(nbytes: int) -> int:
    return (nbytes + _SHM_ALIGN - 1) // _SHM_ALIGN * _SHM_ALIGN


def _process_parse_chunk(payload):
    """Worker-side parse and return. Large numpy arrays (decoded image
    batches) go into a shared-memory ring slot and come back as (dtype,
    shape, offset) descriptors; small ones ride the pickle pipe. With no
    free slot the batch returns inline. When images are deferred to the
    parent, a fast-path failure returns ("fallback", ...) and the parent
    runs the oracle, which decodes."""
    parser = _PROCESS_PARSER
    if parser is None:
        raise RuntimeError("process pool worker missing parser init")
    stats = ParseStats()  # a per-chunk delta: workers cannot share the parent's
    fast = _PROCESS_FAST.parser if _PROCESS_FAST is not None else None
    fallbacks_before = fast.fallbacks if fast is not None else 0
    if _PROCESS_DEFER:
        parsed = None
        if fast is not None:
            chunk, roi = _split_payload(payload)
            try:
                parsed = fast.parse_batch(_regroup_chunk(chunk), roi=roi,
                                          defer_images=True)
            except Exception:  # noqa: BLE001 — the parent re-parses with the oracle
                _PROCESS_FAST.note_fallback()
    else:
        parsed = _parse_chunk_impl(_PROCESS_FAST, parser, payload, stats)
    if fast is not None:
        stats.fast_fallbacks = fast.fallbacks - fallbacks_before
    delta = stats.snapshot()
    delta = delta if any(delta.values()) else None
    if parsed is None:
        return ("fallback" if _PROCESS_DEFER else "dropped", delta)
    flat = list(parsed.items())
    free_queue = _PROCESS_SHM_FREE
    large = [
        (k, v) for k, v in flat
        if isinstance(v, np.ndarray) and v.nbytes >= _SHM_MIN_SHIP_BYTES
    ]
    if free_queue is None or not large:
        return ("inline", flat, delta)
    need = sum(_shm_align(v.nbytes) for _, v in large)
    try:
        # Non-blocking: before the parent seeds the ring the queue is
        # empty and chunks must not stall.
        name = free_queue.get_nowait()
    except queue.Empty:
        return ("inline", flat, delta)
    shm = _shm_attach(name)
    if need > shm.size:
        free_queue.put(name)
        return ("inline", flat, delta)
    entries = []
    offset = 0
    for key, value in flat:
        if not any(key == k for k, _ in large):
            entries.append((key, None, value))
            continue
        view = np.frombuffer(shm.buf, dtype=value.dtype, count=value.size,
                             offset=offset).reshape(value.shape)
        np.copyto(view, value)
        del view
        entries.append((key, (value.dtype, value.shape, offset), None))
        offset += _shm_align(value.nbytes)
    return ("shm", name, entries, delta)


class _ShmSlotToken:
    """Returns a ring slot to the free queue when the last view of the
    batch it carries is collected."""

    __slots__ = ("_ring", "_name")

    def __init__(self, ring: "_ShmBatchRing", name: str):
        self._ring = ring
        self._name = name

    def __del__(self):
        self._ring.release(self._name)


class _ShmArray(np.ndarray):
    """ndarray view into a shm ring slot; keeps the slot's release token
    alive as long as the array (or any view of it) exists."""

    _t2r_token: Optional[_ShmSlotToken] = None


def _shm_free_bytes() -> Optional[int]:
    try:
        stat = os.statvfs(_SHM_DIR)
    except OSError:
        return None
    return stat.f_bavail * stat.f_frsize


class _ShmBatchRing:
    """Shared-memory slots cycling worker -> consumer.

    The parent creates the slots and seeds the workers' free queue; a
    worker takes a name, writes one parsed batch and returns the name; the
    parent wraps the slot in numpy views whose token puts the name back
    once the consumer drops the batch. A consumer that keeps batches only
    sends workers to the inline path; it never blocks the pipeline.

    Shared memory is sparse: creating a slot larger than what /dev/shm
    holds succeeds, and the first write past it kills the worker with
    SIGBUS. So the ring checks the free space first and raises with the
    size it needs and the size it found.
    """

    def __init__(self, free_queue, slot_bytes: int, num_slots: int):
        from multiprocessing import shared_memory

        need = slot_bytes * num_slots
        free = _shm_free_bytes()
        if free is not None and need > free:
            raise RuntimeError(
                f"the process backend's shared-memory ring needs {need} bytes "
                f"({num_slots} slots of {slot_bytes}) but {_SHM_DIR} has "
                f"{free} bytes free; enlarge {_SHM_DIR} or set T2R_PARSE_SHM=0"
            )
        self.slot_bytes = slot_bytes
        self.slots: Dict[str, Any] = {}
        self.free_queue = free_queue
        created: List[Any] = []
        try:
            for _ in range(num_slots):
                created.append(shared_memory.SharedMemory(create=True, size=slot_bytes))
        except OSError:
            for shm in created:
                shm.close()
                shm.unlink()
            raise
        # Every slot exists before any name is published to the workers.
        for shm in created:
            self.slots[shm.name] = shm
            self.free_queue.put(shm.name)
        self._closed = False
        self._zombies: List[Any] = []

    def release(self, name: str) -> None:
        if not self._closed:
            try:
                self.free_queue.put_nowait(name)
            except (ValueError, OSError, queue.Full):
                pass  # the queue closed under a late release

    def close(self) -> None:
        self._closed = True
        for shm in self.slots.values():
            try:
                shm.unlink()
            except FileNotFoundError:
                pass
            try:
                shm.close()
            except BufferError:
                # A consumer still holds views: the mapping frees with them.
                self._zombies.append(shm)
        self.slots = {}


class _ParallelBatcher:
    """Ordered parallel parse: up to `max_in_flight` chunks in a worker
    pool, results yielded in submission order (as (chunk, result) pairs
    with `with_chunks`). The default pool is a ThreadPoolExecutor owned by
    this batcher; a pool passed in (the process backend's) outlives it, and
    results it leaves unconsumed go to `on_discard`."""

    def __init__(self, chunks: Iterator, parse_fn: Callable, num_workers: int,
                 max_in_flight: Optional[int] = None,
                 pool: Optional[concurrent.futures.Executor] = None,
                 on_discard: Optional[Callable] = None, with_chunks: bool = False):
        self._chunks = chunks
        self._parse_fn = parse_fn
        self._owns_pool = pool is None
        self._pool = pool or concurrent.futures.ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="t2r-parse")
        self._in_flight: "queue.Queue" = queue.Queue()
        self._max_in_flight = max_in_flight or num_workers + 2
        self._exhausted = False
        self._on_discard = on_discard
        self._with_chunks = with_chunks

    def _submit_one(self) -> bool:
        try:
            chunk = next(self._chunks)
        except StopIteration:
            self._exhausted = True
            return False
        self._in_flight.put((chunk, self._pool.submit(self._parse_fn, chunk)))
        return True

    def __iter__(self):
        try:
            while not self._exhausted and self._in_flight.qsize() < self._max_in_flight:
                self._submit_one()
            while not self._in_flight.empty():
                chunk, future = self._in_flight.get()
                if not self._exhausted:
                    self._submit_one()
                result = future.result()
                yield (chunk, result) if self._with_chunks else result
        finally:
            if self._owns_pool:
                self._pool.shutdown(wait=False, cancel_futures=True)
            else:
                # Cancel what is queued; drain what already ran so its
                # resources (shm slots) are returned.
                while not self._in_flight.empty():
                    _, future = self._in_flight.get()
                    if future.cancel():
                        continue
                    try:
                        result = future.result()
                    except Exception:  # noqa: BLE001 — a discarded batch's error
                        continue
                    if self._on_discard is not None:
                        self._on_discard(result)


def _host_shard() -> tuple:
    """(rank, world size) of this process: torch.distributed's, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class RecordDataset:
    """Iterable of parsed, batched TensorSpecStruct batches.

    Args:
      specs: feature(+label) spec structure driving the generated parser.
      file_patterns: glob pattern(s), or a {dataset_key: patterns} map for
        multi-dataset specs (zipped element-wise).
      batch_size: per-host batch size; with drop_remainder shapes are static.
      mode: 'train' enables shuffling and infinite repeat by default.
      shuffle_buffer_size: record-level shuffle window.
      repeat: None -> infinite for train, one epoch otherwise.
      seed: deterministic shuffling and ROI offsets when set.
      prefetch_depth: parsed batches buffered ahead by a background thread.
      file_fraction: use only the first fraction of files (data ablation).
      num_parse_workers: parse pool size; None -> default_parse_workers(),
        0 -> synchronous.
      parse_backend: 'thread' or 'process' (None -> T2R_PARSE_BACKEND).
      parse_fast: the wire-format fast parser with SpecParser fallback
        (None -> T2R_PARSE_FAST).
      decode_roi: {flat spec key: DecodeROI}: decode-time crops of the
        named image fields (data/roi.py), honored while T2R_DECODE_ROI=1.
      shard_by_host: each process of a torch.distributed group reads only
        its round-robin slice of the files.
      data_shard: (index, count) of this rank's data x fsdp shard: with
        shard_by_host the files are split by it, and each batch holds
        batch_size / count records (the shard of a global batch).

    Where a card is visible, uint8 images are parsed into pinned buffers
    of a `PinnedRing` (the thread backend, and the parent's decodes of the
    process backend).
    """

    # Set before __init__ can fail, for close() and __del__.
    _process_pool: Optional[concurrent.futures.Executor] = None
    _shm_ring: Optional[_ShmBatchRing] = None
    _shm_free_queue = None

    def __init__(
        self,
        specs,
        file_patterns: Union[str, Sequence[str], Mapping[str, Union[str, Sequence[str]]]],
        batch_size: int,
        mode: str = "train",
        shuffle_buffer_size: int = 512,
        repeat: Optional[bool] = None,
        seed: Optional[int] = None,
        prefetch_depth: int = 2,
        cycle_length: int = 4,
        drop_remainder: bool = True,
        file_fraction: float = 1.0,
        num_parse_workers: Optional[int] = None,
        parse_backend: Optional[str] = None,
        parse_fast: Optional[bool] = None,
        decode_roi: Optional[Mapping[str, DecodeROI]] = None,
        shard_by_host: bool = False,
        data_shard: Optional[Tuple[int, int]] = None,
    ):
        self._specs = specs
        self._decode_roi = (
            normalize_decode_rois(decode_roi, specs)
            if decode_roi and default_decode_roi() else None
        )
        self._parse_backend = (
            default_parse_backend() if parse_backend is None else parse_backend)
        if self._parse_backend not in ("thread", "process"):
            raise ValueError(
                f"parse_backend must be 'thread' or 'process', got "
                f"{self._parse_backend!r}")
        self._parser = SpecParser(specs)
        self._parse_fast = default_parse_fast() if parse_fast is None else parse_fast
        self._fast_state = _FastParseState(specs, self._parse_fast)
        self._parse_stats = ParseStats()
        self._batch_size = batch_size
        self._train = mode == "train"
        self._shuffle_buffer_size = shuffle_buffer_size if self._train else 0
        self._repeat = self._train if repeat is None else repeat
        self._seed = seed
        self._prefetch_depth = prefetch_depth
        self._cycle_length = cycle_length
        self._drop_remainder = drop_remainder
        self._num_parse_workers = (
            default_parse_workers() if num_parse_workers is None else num_parse_workers)
        self._ring = PinnedRing() if torch.cuda.is_available() else None

        if isinstance(file_patterns, Mapping):
            self._files: Dict[str, List[str]] = {
                k: tfrecord.list_files(v) for k, v in file_patterns.items()}
        else:
            self._files = {"": tfrecord.list_files(file_patterns)}
        if file_fraction < 1.0:
            for k, files in self._files.items():
                self._files[k] = files[: max(1, int(len(files) * file_fraction))]
        if shard_by_host and data_shard is not None and data_shard[1] > 1:
            if batch_size % data_shard[1]:
                raise ValueError(
                    f"batch_size {batch_size} does not split over "
                    f"{data_shard[1]} data x fsdp shards")
            self._batch_size = batch_size // data_shard[1]
        if shard_by_host:
            index, count = data_shard if data_shard is not None else _host_shard()
            if count > 1:
                for k, files in self._files.items():
                    mine = files[index::count]
                    if not mine:
                        raise ValueError(
                            f"Host {index}/{count} got no files for dataset "
                            f"{k!r} ({len(files)} files total); need at "
                            "least one shard per host.")
                    self._files[k] = mine
        missing = set(self._parser.dataset_keys) - set(self._files.keys())
        if missing:
            raise ValueError(
                f"Specs reference dataset keys {sorted(missing)} with no file "
                f"patterns (got {sorted(self._files.keys())})")

    def _alloc(self):
        return self._ring.alloc if self._ring is not None else None

    def _record_stream(self) -> Iterator:
        rng = random.Random(self._seed)
        dataset_keys = list(self._files.keys())
        if dataset_keys == [""]:
            records: Iterator = _interleave_files(
                self._files[""], self._cycle_length, shuffle_files=self._train,
                rng=rng, repeat=self._repeat)
        else:
            # Multi-dataset zip: the streams stay aligned, so each key's
            # files are read in sorted order without interleave, epochs
            # are zipped jointly, and unequal record counts are an error.
            def zipped():
                while True:
                    epoch = {
                        k: _interleave_files(self._files[k], 1, shuffle_files=False,
                                             rng=None, repeat=False)
                        for k in dataset_keys
                    }
                    while True:
                        row = {}
                        done = []
                        for k, stream in epoch.items():
                            try:
                                row[k] = next(stream)
                            except StopIteration:
                                done.append(k)
                        if done:
                            if len(done) != len(epoch):
                                raise ValueError(
                                    "Multi-dataset zip misalignment: datasets "
                                    f"{sorted(done)} exhausted before "
                                    f"{sorted(set(epoch) - set(done))}; record "
                                    "counts must match across dataset keys.")
                            break
                        yield row
                    if not self._repeat:
                        return

            records = zipped()
        if self._shuffle_buffer_size > 1:
            records = _shuffle_records(records, self._shuffle_buffer_size, rng)
        return records

    def _chunks(self) -> Iterator:
        stream = self._record_stream()
        roi_rng = np.random.default_rng(self._seed) if self._decode_roi else None
        while True:
            chunk = list(itertools.islice(stream, self._batch_size))
            if not chunk:
                return
            if len(chunk) < self._batch_size and self._drop_remainder:
                return
            if self._decode_roi is None:
                yield chunk
                continue
            # Offsets resolve here, once per chunk: every parser of this
            # payload crops with the same rects.
            yield ("roi", chunk, resolve_decode_rois(
                self._decode_roi, self._specs, len(chunk), roi_rng))

    def _parse_chunk(self, chunk) -> Optional[TensorSpecStruct]:
        return _parse_chunk_impl(self._fast_state, self._parser, chunk,
                                 self._parse_stats, alloc=self._alloc())

    def _max_in_flight(self) -> int:
        return self._num_parse_workers + max(self._prefetch_depth, 1)

    def _maybe_seed_ring(self, flat) -> None:
        """Creates the shm ring when the first large batch comes back
        inline: a slot must fit a real parsed batch."""
        if self._shm_ring is not None or self._shm_free_queue is None:
            return
        need = sum(
            _shm_align(v.nbytes) for _, v in flat
            if isinstance(v, np.ndarray) and v.nbytes >= _SHM_MIN_SHIP_BYTES)
        if need == 0:
            return
        slot_bytes = need + need // 2 + (1 << 20)
        self._shm_ring = _ShmBatchRing(
            self._shm_free_queue, slot_bytes, self._max_in_flight() + 2)

    def _discard_worker_payload(self, pair) -> None:
        """Returns the ring slot of a parsed batch nobody consumed."""
        payload = pair[1] if isinstance(pair, tuple) and len(pair) == 2 else pair
        if payload and payload[0] == "shm" and self._shm_ring is not None:
            self._shm_ring.release(payload[1])

    def _rebuild_struct(self, pair) -> Optional[TensorSpecStruct]:
        """Parent-side batch assembly of a process worker's result (inline,
        shm, dropped or fallback), folding its counters into ParseStats and
        decoding deferred images."""
        chunk, payload = pair
        delta = payload[-1] if isinstance(payload[-1], dict) else None
        if delta:
            self._parse_stats.merge(delta)
        if payload[0] == "dropped":
            return None
        if payload[0] == "fallback":
            return _parse_chunk_impl(None, self._parser, chunk, self._parse_stats)
        out = TensorSpecStruct()
        if payload[0] == "inline":
            for key, value in payload[1]:
                out[key] = value
            self._maybe_seed_ring(payload[1])
        else:
            _, name, entries = payload[0], payload[1], payload[2]
            ring = self._shm_ring
            if ring is None or name not in ring.slots:
                raise RuntimeError(f"worker returned unknown shm slot {name!r}")
            shm = ring.slots[name]
            token = _ShmSlotToken(ring, name)
            for key, desc, value in entries:
                if desc is None:
                    out[key] = value
                    continue
                dtype, shape, offset = desc
                view = (np.frombuffer(shm.buf, dtype=dtype, count=int(np.prod(shape)),
                                      offset=offset).reshape(shape).view(_ShmArray))
                view._t2r_token = token
                out[key] = view
        if any(isinstance(v, DeferredImages) for v in out.values()):
            fast = self._fast_state.parser or FastSpecParser(self._specs)
            try:
                return fast.finish(out, alloc=self._alloc())
            except Exception:  # noqa: BLE001 — the oracle decides, as for a fast-path failure
                self._fast_state.note_fallback()
                return _parse_chunk_impl(None, self._parser, chunk, self._parse_stats)
        return out

    def _get_process_pool(self) -> concurrent.futures.Executor:
        """The dataset's spawned worker pool, made once: a worker's start
        (a fresh interpreter importing torch) is paid per dataset, not per
        epoch."""
        if self._process_pool is None:
            import multiprocessing

            # Spawn, not fork: the parent holds CUDA and other threads.
            context = multiprocessing.get_context("spawn")
            if default_parse_shm():
                # The free-slot queue exists up front; the slots are made
                # once a batch's size is known (_maybe_seed_ring).
                self._shm_free_queue = context.Queue()
            # Build the native libraries here, once, before any worker
            # loads them.
            tfrecord.masked_crc32c(b"")
            defer = codec.needs_card()
            if not defer:
                codec.codec_name()
            self._process_pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=self._num_parse_workers, mp_context=context,
                initializer=_process_pool_init,
                initargs=(
                    pickle.dumps(self._specs), self._parse_fast,
                    self._shm_free_queue,
                    default_decode_cache_mb() // max(self._num_parse_workers, 1),
                    defer,
                ),
            )
        return self._process_pool

    def close(self, wait: bool = True) -> None:
        """Shuts down the process pool (waiting for its workers unless
        `wait` is False) and the shm ring; no-op for the thread backend."""
        if self._process_pool is not None:
            self._process_pool.shutdown(wait=wait, cancel_futures=True)
            self._process_pool = None
        if self._shm_ring is not None:
            self._shm_ring.close()
            self._shm_ring = None
        if self._shm_free_queue is not None:
            self._shm_free_queue.close()
            self._shm_free_queue = None

    def __del__(self):
        # Collection may run on any thread, the pool's own included: never
        # wait there.
        self.close(wait=False)

    def stats(self) -> Dict[str, int]:
        """Degradation counters: records and batches dropped under
        T2R_PARSE_ON_ERROR=skip, and fast-parser fallbacks (the parent's
        and the process workers')."""
        out = self._parse_stats.snapshot()
        fast = self._fast_state.parser
        out["fast_fallbacks"] += fast.fallbacks if fast is not None else 0
        return out

    def __iter__(self) -> Iterator[TensorSpecStruct]:
        if self._num_parse_workers > 0 and self._parse_backend == "process":
            batches: Iterator[Optional[TensorSpecStruct]] = map(
                self._rebuild_struct,
                _ParallelBatcher(
                    self._chunks(), _process_parse_chunk,
                    num_workers=self._num_parse_workers,
                    max_in_flight=self._max_in_flight(),
                    pool=self._get_process_pool(),
                    on_discard=self._discard_worker_payload, with_chunks=True,
                ),
            )
        elif self._num_parse_workers > 0:
            batches = iter(_ParallelBatcher(
                self._chunks(), self._parse_chunk,
                num_workers=self._num_parse_workers,
                max_in_flight=self._max_in_flight()))
        else:
            batches = map(self._parse_chunk, self._chunks())
        # Skip-mode whole-batch drops surface as None.
        batches = (batch for batch in batches if batch is not None)
        if self._prefetch_depth > 0:
            return iter(_Prefetcher(batches, self._prefetch_depth))
        return batches


class GeneratorDataset:
    """Batches from a Python generator of per-example numpy dicts."""

    def __init__(self, generator_fn: Callable[[], Iterator[Mapping[str, np.ndarray]]],
                 batch_size: int, prefetch_depth: int = 1):
        self._generator_fn = generator_fn
        self._batch_size = batch_size
        self._prefetch_depth = prefetch_depth

    def __iter__(self) -> Iterator[TensorSpecStruct]:
        def batches():
            source = self._generator_fn()
            while True:
                rows = list(itertools.islice(source, self._batch_size))
                if len(rows) < self._batch_size:
                    return
                out = TensorSpecStruct()
                for key in rows[0].keys():
                    out[key] = np.stack([np.asarray(r[key]) for r in rows])
                yield out

        if self._prefetch_depth > 0:
            return iter(_Prefetcher(batches(), self._prefetch_depth))
        return batches()


def weighted_interleave(datasets: Sequence[RecordDataset], weights: Sequence[float],
                        seed: Optional[int] = None) -> Iterator[TensorSpecStruct]:
    """Samples batches from datasets in proportion to weights."""
    rng = random.Random(seed)
    iterators = [iter(d) for d in datasets]
    total = float(sum(weights))
    probs = [w / total for w in weights]
    while iterators:
        idx = rng.choices(range(len(iterators)), weights=probs, k=1)[0]
        try:
            yield next(iterators[idx])
        except StopIteration:
            del iterators[idx], probs[idx]
            if probs:
                s = sum(probs)
                probs = [p / s for p in probs]
