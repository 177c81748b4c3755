"""Policy serving: micro-batching server, bucket ladder, metrics."""

from tensor2robot_tpu_torch.serving.server import (
    DeadlineExceeded,
    PolicyServer,
    PredictFailed,
    PredictTimeout,
    RequestRejected,
    RequestShed,
    ServeError,
    ServeFuture,
    ServeResponse,
    ServerClosed,
)
