"""Per-request observability for the policy server.

Every request carries a span record through its lifecycle
(enqueue -> dispatch -> compute -> reply); the server aggregates them into
a structured snapshot: monotonic counters, the queue depth, latency
percentiles over a bounded ring of recent spans, and the batch-fill ratio
(the fraction of dispatched batch slots that carried real requests).
Port of tensor2robot_tpu/serving/metrics.py.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

__all__ = ["RequestSpan", "ServerMetrics", "percentile"]


class RequestSpan:
    """Monotonic timestamps for one request's hops (seconds). Unset hops
    stay None (e.g. a shed request never dispatches)."""

    __slots__ = ("t_enqueue", "t_dispatch", "t_compute_done", "t_reply")

    def __init__(self, t_enqueue: float):
        self.t_enqueue = t_enqueue
        self.t_dispatch: Optional[float] = None
        self.t_compute_done: Optional[float] = None
        self.t_reply: Optional[float] = None

    def as_millis(self) -> Dict[str, float]:
        """queue/compute/reply/total durations in ms (None-safe)."""
        out: Dict[str, float] = {}
        if self.t_dispatch is not None:
            out["queue_ms"] = (self.t_dispatch - self.t_enqueue) * 1e3
        if self.t_compute_done is not None and self.t_dispatch is not None:
            out["compute_ms"] = (self.t_compute_done - self.t_dispatch) * 1e3
        if self.t_reply is not None and self.t_compute_done is not None:
            out["reply_ms"] = (self.t_reply - self.t_compute_done) * 1e3
        if self.t_reply is not None:
            out["total_ms"] = (self.t_reply - self.t_enqueue) * 1e3
        return out


def percentile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank percentile over an ascending list (0 when empty)."""
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1, int(round(q * (len(sorted_values) - 1))))
    return sorted_values[idx]


class ServerMetrics:
    """Thread-safe aggregate; all mutators are O(1)."""

    def __init__(self, span_window: int = 2048):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=span_window)
        self._counters = {
            "admitted": 0,
            "completed": 0,
            "failed": 0,
            "shed": 0,
            "rejected": 0,
            "deadline_missed": 0,
            "deadline_dropped": 0,
            "hot_swaps": 0,
            "batches": 0,
        }
        self._batch_slots = 0
        self._batch_real = 0
        self._per_bucket: Dict[int, int] = {}
        self._failed_by_class: Dict[str, int] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def count_failure(self, failure_class: str, n: int = 1) -> None:
        """Increments `failed` and its per-class attribution together."""
        with self._lock:
            self._counters["failed"] += n
            self._failed_by_class[failure_class] = (
                self._failed_by_class.get(failure_class, 0) + n
            )

    def observe_batch(self, bucket: int, real: int) -> None:
        with self._lock:
            self._counters["batches"] += 1
            self._batch_slots += bucket
            self._batch_real += real
            self._per_bucket[bucket] = self._per_bucket.get(bucket, 0) + 1

    def observe_replies(self, spans: List[Dict[str, float]]) -> None:
        """Records a served batch's reply spans and its completed count
        together, so the latency window and the counter cannot drift."""
        with self._lock:
            self._spans.extend(spans)
            self._counters["completed"] += len(spans)

    def snapshot(self, queue_depth: int = 0) -> Dict:
        with self._lock:
            counters = dict(self._counters)
            spans = list(self._spans)
            slots, real = self._batch_slots, self._batch_real
            per_bucket = dict(self._per_bucket)
            failed_by_class = dict(self._failed_by_class)
        totals = sorted(s["total_ms"] for s in spans)
        queues = sorted(s.get("queue_ms", 0.0) for s in spans)
        computes = sorted(s.get("compute_ms", 0.0) for s in spans)
        return {
            "counters": counters,
            "failed_by_class": failed_by_class,
            "queue_depth": queue_depth,
            "batch_fill_ratio": (real / slots) if slots else 0.0,
            "batches_by_bucket": {
                str(k): v for k, v in sorted(per_bucket.items())
            },
            "latency_ms": {
                "p50_total": percentile(totals, 0.50),
                "p99_total": percentile(totals, 0.99),
                "p50_queue": percentile(queues, 0.50),
                "p99_queue": percentile(queues, 0.99),
                "p50_compute": percentile(computes, 0.50),
                "p99_compute": percentile(computes, 0.99),
                "window": len(spans),
            },
        }
