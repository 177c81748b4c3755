"""PolicyServer: dynamic micro-batching over an AbstractPredictor.

Many concurrent clients (robots, planners, web frontends) share one
predictor. The server turns per-client single-episode traffic into
bucket-sized batches:

  * a bounded request queue with per-request deadlines and admission
    control — when the queue is full the overload policy either sheds the
    OLDEST queued request (freshest-first service, the right default for
    control loops where a stale action is worthless) or rejects the
    incoming one (`T2R_SERVE_OVERLOAD`);
  * a dispatcher thread that coalesces queued requests up to a
    max-wait/max-batch window (`T2R_SERVE_MAX_WAIT_MS`), pads the batch
    to the smallest fitting bucket (serving/buckets.py; the ladder of the
    loaded export's `warmup_batch_sizes` unless an argument or
    `T2R_SERVE_BUCKETS` sets one) and runs ONE predict per batch; every
    bucket is prewarmed at start on the export's own warmup requests (or
    synthesized batches), so no request meets a first-call cost (kernel
    build, cuDNN algorithm search);
  * hot swap: `hot_swap()` rides the predictor's async restore; through
    `set_restore_prewarm` the incoming version runs every bucket before
    it is swapped in (a failed prewarm keeps the old version), batches
    drain on the old version meanwhile, and every response reports the
    model version that computed it;
  * an optional compute watchdog (`T2R_SERVE_PREDICT_TIMEOUT_MS`);
  * per-request spans and counters (serving/metrics.py) exported as one
    structured `snapshot()`, and typed errors for every failure.

Port of tensor2robot_tpu/serving/server.py. The predictor's `predict` is
called only from the dispatcher (and from the prewarms): a predict on
the submit path would serialize clients behind the model. AOT restore
tiers, compile caches, quantized regimes and the multi-policy
`exported_policy_loader` are not ported (ROADMAP.md A10).
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch import flags as t2r_flags
from tensor2robot_tpu_torch.serving import buckets as buckets_lib
from tensor2robot_tpu_torch.serving.metrics import RequestSpan, ServerMetrics
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    flatten_spec_structure,
    make_random_numpy,
    numpy_dtype,
)

__all__ = [
    "PolicyServer",
    "ServeFuture",
    "ServeResponse",
    "ServeError",
    "RequestRejected",
    "RequestShed",
    "DeadlineExceeded",
    "ServerClosed",
    "PredictFailed",
    "PredictTimeout",
]


class ServeError(RuntimeError):
    """Base class for request-level serving failures."""


class RequestRejected(ServeError):
    """Admission control refused the request (reject overload policy)."""


class RequestShed(ServeError):
    """The request was shed from a full queue (shed_oldest policy)."""


class DeadlineExceeded(ServeError):
    """The request's deadline passed before compute dispatched it."""


class ServerClosed(ServeError):
    """The server stopped before the request could be served."""


class PredictFailed(ServeError):
    """The predictor raised mid-batch; this batch failed, the loop lives.
    `failure_class` carries the original exception's type name (also the
    key in the metrics failed_by_class breakdown)."""

    def __init__(self, message: str, failure_class: str = "PredictFailed"):
        super().__init__(message)
        self.failure_class = failure_class


class PredictTimeout(ServeError):
    """The predictor exceeded the compute watchdog; the batch's futures
    failed typed and the dispatcher moved on (the stuck call is abandoned
    on a daemon thread — a hung device call cannot be cancelled from the
    host, only routed around)."""


class ServeResponse:
    """One request's outputs + the model version that computed them."""

    __slots__ = ("outputs", "model_version", "spans")

    def __init__(self, outputs: Dict[str, np.ndarray], model_version: int,
                 spans: Dict[str, float]):
        self.outputs = outputs
        self.model_version = model_version
        self.spans = spans


class ServeFuture:
    """Completion handle returned by submit(); result() blocks."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._event = threading.Event()
        self._response: Optional[ServeResponse] = None
        self._error: Optional[BaseException] = None
        self._callbacks: List = []
        self._cb_lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def error(self) -> Optional[BaseException]:
        """The failure, if the future completed with one (None while
        pending or on success), so a completion callback can branch
        without re-raising."""
        return self._error if self._event.is_set() else None

    def result(self, timeout: Optional[float] = None) -> ServeResponse:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} still pending after {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._response

    def add_done_callback(self, fn) -> None:
        """Calls `fn(future)` when the future completes, at once (on the
        caller's thread) if it already has. Otherwise it runs on the
        completing thread (the dispatcher), so it must be cheap and must
        not block; one that raises is logged and the dispatcher serves
        on."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _complete(self) -> None:
        # Set and drain under the lock, so a callback is either queued
        # before completion (and run here) or run by add_done_callback.
        with self._cb_lock:
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — a client's callback
                logging.exception(
                    "done callback of request %d raised", self.request_id
                )

    def _set_response(self, response: ServeResponse) -> None:
        self._response = response
        self._complete()

    def _set_error(self, error: BaseException) -> None:
        self._error = error
        self._complete()


class _Request:
    __slots__ = ("id", "features", "deadline", "span", "future")

    def __init__(self, request_id: int, features: Dict[str, np.ndarray],
                 deadline: float, span: RequestSpan):
        self.id = request_id
        self.features = features
        self.deadline = deadline
        self.span = span
        self.future = ServeFuture(request_id)


class PolicyServer:
    """Micro-batching policy server over a restored AbstractPredictor.

    Constructor arguments override the `T2R_SERVE_*` flag defaults;
    `batch_buckets` sets the bucket ladder. The predictor must be restored
    (or restorable) before start().
    """

    def __init__(
        self,
        predictor,
        batch_buckets: Optional[Sequence[int]] = None,
        max_queue: Optional[int] = None,
        max_wait_ms: Optional[int] = None,
        overload: Optional[str] = None,
        default_deadline_ms: Optional[int] = None,
        predict_timeout_ms: Optional[int] = None,
    ):
        self._predictor = predictor
        self._explicit_buckets = batch_buckets
        self._max_queue = (
            max_queue if max_queue is not None
            else t2r_flags.get_int("T2R_SERVE_MAX_QUEUE")
        )
        self._max_wait_s = (
            max_wait_ms if max_wait_ms is not None
            else t2r_flags.get_int("T2R_SERVE_MAX_WAIT_MS")
        ) / 1e3
        self._overload = (
            overload if overload is not None
            else t2r_flags.get_enum("T2R_SERVE_OVERLOAD")
        )
        if self._overload not in ("shed_oldest", "reject"):
            raise ValueError(
                f"overload must be shed_oldest|reject, got {self._overload!r}"
            )
        self._default_deadline_s = (
            default_deadline_ms if default_deadline_ms is not None
            else t2r_flags.get_int("T2R_SERVE_DEADLINE_MS")
        ) / 1e3
        self._predict_timeout_s = (
            predict_timeout_ms if predict_timeout_ms is not None
            else t2r_flags.get_int("T2R_SERVE_PREDICT_TIMEOUT_MS")
        ) / 1e3  # 0 = watchdog off (predict on the dispatcher thread)
        self._buckets: Tuple[int, ...] = ()
        self._spec_checks: List[Tuple] = []
        self._bucket_batches: Dict[int, Dict[str, np.ndarray]] = {}
        # {version: buckets prewarmed on it}, at start and per swap.
        self._prewarmed: Dict[str, List[int]] = {}
        self._warmup_source: Optional[str] = None  # "export" | "synthesized"
        self._metrics = ServerMetrics()
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._ids = itertools.count(1)
        self._dispatcher: Optional[threading.Thread] = None
        self._started = False
        self._closed = False

    # -- lifecycle ------------------------------------------------------------

    def start(self, prewarm: bool = True) -> "PolicyServer":
        """Resolves the bucket ladder from the loaded export, optionally
        prewarms every bucket (one predict per served shape BEFORE traffic
        arrives), installs the restore prewarm for hot swaps, and starts
        the dispatcher."""
        if self._started:
            raise RuntimeError("PolicyServer.start() called twice")
        if self._predictor.model_version < 0:
            if not self._predictor.restore():
                raise RuntimeError(
                    "predictor restore failed; cannot start the server"
                )
        loaded = getattr(self._predictor, "loaded_model", None)
        self._buckets = buckets_lib.resolve_buckets(
            self._explicit_buckets, getattr(loaded, "metadata", None)
        )
        spec = self._predictor.get_feature_specification()
        # Precompiled validation table: submit() runs per request on the
        # client thread, so the spec walk must not. Dtypes are coerced to
        # the spec's so one float64 request cannot change a batch's dtype.
        self._spec_checks = []
        for key, leaf in flatten_spec_structure(spec).items():
            if not isinstance(leaf, ExtendedTensorSpec) or leaf.is_optional:
                continue
            dims = tuple(leaf.shape)
            static = dims if all(d is not None for d in dims) else None
            self._spec_checks.append(
                (key, dims, static, len(dims), numpy_dtype(leaf.dtype))
            )
        self._bucket_batches = self._build_bucket_batches(loaded, spec)
        if prewarm:
            self._prewarm()
        installer = getattr(self._predictor, "set_restore_prewarm", None)
        if installer is not None:
            installer(self._prewarm_restored)
        self._started = True
        self._closed = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="t2r-serve-dispatch", daemon=True
        )
        self._dispatcher.start()
        return self

    def _build_bucket_batches(self, loaded, spec) -> Dict[int, Dict[str, np.ndarray]]:
        """One spec-conforming batch per bucket: the export's warmup
        requests where it has them, synthesized random batches otherwise
        (the shapes are the contract, not the values)."""
        warmed = {}
        export_dir = getattr(loaded, "export_dir", None)
        if export_dir:
            try:
                warmed = buckets_lib.load_warmup_batches(
                    export_dir, spec, getattr(loaded, "metadata", None)
                )
            except Exception as err:  # noqa: BLE001 — warmup payloads are
                # an optimization; synthesized batches warm the same shapes.
                logging.warning("warmup tfrecord unusable (%s); synthesizing", err)
        batches = {}
        for bucket in self._buckets:
            batch = warmed.get(bucket)
            if batch is None:
                batch = dict(flatten_spec_structure(
                    make_random_numpy(spec, batch_size=bucket, seed=0)
                ).items())
            batches[bucket] = batch
        self._warmup_source = "export" if warmed else "synthesized"
        return batches

    def _prewarm(self) -> None:
        """One predict per bucket before traffic."""
        for bucket in self._buckets:
            self._predictor.predict(self._bucket_batches[bucket])
        self._prewarmed[str(self._predictor.model_version)] = list(self._buckets)

    def _prewarm_restored(self, loaded, serve) -> None:
        """Runs on the restore thread before a new version is swapped in:
        every bucket runs on the incoming version while the old one keeps
        serving, so the swap never puts a first call in front of traffic.
        Raising aborts the swap."""
        for bucket in self._buckets:
            serve(self._bucket_batches[bucket])
        version = os.path.basename(str(getattr(loaded, "export_dir", "")).rstrip("/"))
        self._prewarmed[version] = list(self._buckets)

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stops the dispatcher. drain=True serves everything already
        queued first; drain=False fails queued requests with
        ServerClosed."""
        with self._cond:
            if not self._started:
                return
            self._closed = True
            if not drain:
                while self._queue:
                    request = self._queue.popleft()
                    request.future._set_error(
                        ServerClosed(
                            f"server stopped, request {request.id} dropped"
                        )
                    )
                    self._metrics.count_failure("ServerClosed")
            self._cond.notify_all()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=timeout)
        self._started = False

    def __enter__(self) -> "PolicyServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface -------------------------------------------------------

    def submit(
        self,
        features: Mapping[str, Any],
        deadline_ms: Optional[float] = None,
    ) -> ServeFuture:
        """Enqueues ONE example (leaf shapes = the spec's, no batch dim);
        returns a future. Never blocks on the model."""
        if not self._started:
            raise RuntimeError("PolicyServer is not started")
        flat = self._validate(features)
        now = time.monotonic()
        deadline = now + (
            deadline_ms / 1e3 if deadline_ms is not None
            else self._default_deadline_s
        )
        request = _Request(next(self._ids), flat, deadline, RequestSpan(now))
        with self._cond:
            if self._closed:
                raise ServerClosed("server is stopping; request refused")
            if len(self._queue) >= self._max_queue:
                if self._overload == "reject":
                    self._metrics.count("rejected")
                    raise RequestRejected(
                        f"queue full ({self._max_queue}); request rejected"
                    )
                victim = self._queue.popleft()
                victim.future._set_error(
                    RequestShed(
                        f"request {victim.id} shed by newer arrival under load"
                    )
                )
                self._metrics.count("shed")
            self._queue.append(request)
            self._metrics.count("admitted")
            self._cond.notify()
        return request.future

    def call(
        self,
        features: Mapping[str, Any],
        deadline_ms: Optional[float] = None,
        timeout: Optional[float] = None,
    ) -> ServeResponse:
        """Blocking convenience: submit + wait. The default wait outlives
        THIS request's deadline."""
        future = self.submit(features, deadline_ms=deadline_ms)
        if timeout is None:
            timeout = (
                deadline_ms / 1e3 if deadline_ms is not None
                else self._default_deadline_s
            ) + 30.0
        return future.result(timeout)

    def _validate(self, features: Mapping[str, Any]) -> Dict[str, np.ndarray]:
        # Clients usually pass the flat dict already; flatten nested input
        # only when a key is not found at the top level.
        flat_in = features
        out: Dict[str, np.ndarray] = {}
        for key, dims, static, rank, want_dtype in self._spec_checks:
            value = flat_in.get(key)
            if value is None and flat_in is features:
                flat_in = dict(flatten_spec_structure(features).items())
                value = flat_in.get(key)
            if value is None:
                raise ValueError(f"request is missing required feature {key!r}")
            value = np.asarray(value)
            shape = value.shape
            ok = shape == static if static is not None else (
                len(shape) == rank
                and all(d is None or d == g for d, g in zip(dims, shape))
            )
            if not ok:
                raise ValueError(
                    f"feature {key!r}: expected one example of shape "
                    f"{dims}, got {shape} (batching is the server's job — "
                    "submit single examples)"
                )
            if value.dtype != want_dtype:
                value = value.astype(want_dtype)
            out[key] = value
        return out

    # -- introspection --------------------------------------------------------

    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._buckets

    def snapshot(self) -> Dict:
        with self._cond:
            depth = len(self._queue)
        snap = self._metrics.snapshot(queue_depth=depth)
        snap["buckets"] = list(self._buckets)
        snap["overload_policy"] = self._overload
        snap["max_queue"] = self._max_queue
        snap["max_wait_ms"] = self._max_wait_s * 1e3
        snap["model_version"] = self._predictor.model_version
        # The loaded version's serving regime, so a fleet can verify a mixed
        # rollout replica by replica: its native layers and attention, its
        # calibration mode and the reduce audit of its program.
        regime = getattr(self._predictor, "quant_regime", None)
        if regime is not None:
            snap["serve_quant"] = regime
            if regime != "none":
                snap["serve_quant_native_layers"] = list(
                    getattr(self._predictor, "native_dot_layers", ()) or ())
                attention = getattr(self._predictor, "native_attention", ()) or ()
                if attention:
                    snap["serve_quant_native_attention"] = list(attention)
                calib = getattr(self._predictor, "calib_mode", None)
                if calib is not None:
                    snap["serve_quant_calib"] = calib
                audit = getattr(self._predictor, "quant_reduce_audit", None)
                if audit is not None:
                    snap["serve_quant_reduce_audit"] = dict(audit)
        snap["warmup_source"] = self._warmup_source
        snap["prewarmed"] = dict(list(self._prewarmed.items()))
        return snap

    def hot_swap(self, wait: bool = False) -> bool:
        """Serves the newest version with no downtime: the predictor
        reloads (async by default) and prewarms every bucket on it while
        batches drain on the current version; the swap lands between
        batches and responses report the model_version that computed
        them."""
        self._metrics.count("hot_swaps")
        return self._predictor.restore(is_async=not wait)

    # -- dispatcher -----------------------------------------------------------

    def _dispatch_loop(self) -> None:
        max_bucket = self._buckets[-1]
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                # Coalesce: from the first request's enqueue, wait up to
                # max_wait for the batch to fill (no wait when it is full
                # or the server is draining).
                window_end = self._queue[0].span.t_enqueue + self._max_wait_s
                while len(self._queue) < max_bucket and not self._closed:
                    remaining = window_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
                    if not self._queue:
                        break  # everything shed while we slept
                # A request whose deadline passed while queued must not
                # occupy a batch slot: dropped typed and counted here.
                batch: List[_Request] = []
                expired: List[_Request] = []
                now = time.monotonic()
                while self._queue and len(batch) < max_bucket:
                    request = self._queue.popleft()
                    if request.deadline < now:
                        expired.append(request)
                    else:
                        batch.append(request)
            for request in expired:
                self._metrics.count("deadline_missed")
                self._metrics.count("deadline_dropped")
                request.future._set_error(
                    DeadlineExceeded(
                        f"request {request.id} dropped at batch formation "
                        f"{(now - request.deadline) * 1e3:.1f}ms past its "
                        "deadline"
                    )
                )
            if not batch:
                continue
            try:
                self._execute_batch(batch)
            except Exception as err:  # noqa: BLE001 — a structural failure
                # must fail THIS batch's futures, never kill the dispatcher
                # (a dead dispatcher behind a live submit() is a silent
                # permanent outage).
                logging.exception(
                    "dispatcher: batch of %d failed structurally", len(batch)
                )
                pending = [r for r in batch if not r.future.done()]
                self._metrics.count_failure("DispatchError", len(pending))
                for request in pending:
                    request.future._set_error(
                        ServeError(
                            f"dispatch failed: {type(err).__name__}: {err}"
                        )
                    )

    def _run_predict_watchdogged(self, features):
        """predict on a daemon thread; the dispatcher waits at most the
        configured budget, then fails the batch typed and moves on."""
        box: Dict[str, Any] = {}
        done = threading.Event()

        def work():
            try:
                box["value"] = self._predictor.predict_versioned(features)
            except BaseException as err:  # noqa: BLE001 — crosses threads
                box["error"] = err
            finally:
                done.set()

        threading.Thread(target=work, name="t2r-serve-predict", daemon=True).start()
        if not done.wait(self._predict_timeout_s):
            raise PredictTimeout(
                f"predict exceeded the {self._predict_timeout_s * 1e3:.0f}"
                "ms compute watchdog; batch failed, call abandoned"
            )
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _execute_batch(self, batch: List[_Request]) -> None:
        now = time.monotonic()
        live: List[_Request] = []
        for request in batch:
            if request.deadline < now:
                self._metrics.count("deadline_missed")
                request.future._set_error(
                    DeadlineExceeded(
                        f"request {request.id} missed its deadline by "
                        f"{(now - request.deadline) * 1e3:.1f}ms before dispatch"
                    )
                )
            else:
                request.span.t_dispatch = now
                live.append(request)
        if not live:
            return
        bucket = buckets_lib.pick_bucket(self._buckets, len(live))
        features = buckets_lib.pad_feature_batch(
            [r.features for r in live], bucket
        )
        try:
            if self._predict_timeout_s > 0:
                outputs, version = self._run_predict_watchdogged(features)
            else:
                outputs, version = self._predictor.predict_versioned(features)
        except Exception as err:  # noqa: BLE001 — one bad batch must not
            # kill the dispatcher; each request learns the typed error.
            if isinstance(err, PredictTimeout):
                failure_class = "PredictTimeout"
                typed: ServeError = err
            else:
                failure_class = type(err).__name__
                typed = PredictFailed(
                    f"predict failed: {failure_class}: {err}",
                    failure_class=failure_class,
                )
            self._metrics.count_failure(failure_class, len(live))
            self._metrics.observe_batch(bucket, len(live))
            for request in live:
                request.future._set_error(typed)
            return
        done = time.monotonic()
        self._metrics.observe_batch(bucket, len(live))
        arrays = {k: np.asarray(v) for k, v in outputs.items()}
        spans = []
        for i, request in enumerate(live):
            request.span.t_compute_done = done
            request.span.t_reply = done
            row = {k: v[i] for k, v in arrays.items()}
            millis = request.span.as_millis()
            request.future._set_response(ServeResponse(row, version, millis))
            spans.append(millis)
        self._metrics.observe_replies(spans)
