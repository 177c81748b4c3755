"""ServeFuture's error() and add_done_callback() against the JAX package's.

The same scenarios run on the port's future and on tensor2robot_tpu's
(tensor2robot_tpu/serving/server.py): what error() reports before and
after completion, when and on which thread a callback runs, and that each
runs exactly once. Then through a PolicyServer: callbacks see every
completion (a reply or a typed failure), and one that raises does not
stop the dispatcher.
"""

import threading

import numpy as np
import pytest

from tensor2robot_tpu.serving import server as jax_server
from tensor2robot_tpu_torch.serving import PolicyServer, PredictFailed
from tensor2robot_tpu_torch.serving import server as port_server
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct
from tensor2robot_tpu_torch.predictors import AbstractPredictor

MODULES = {"port": port_server, "jax": jax_server}


def _response(module):
    return module.ServeResponse({"y": np.zeros(1)}, 3, {})


def _scenario(module, outcome, add_after):
    """Completes a future with `outcome` ('response' or 'error') from
    another thread; returns what an observer sees."""
    future = module.ServeFuture(7)
    seen = {"error_pending": future.error(), "calls": []}
    main = threading.current_thread()

    def callback(f):
        seen["calls"].append((
            threading.current_thread() is main, f.done(), f.error(),
        ))

    if not add_after:
        future.add_done_callback(callback)
    failure = ValueError("boom")

    def complete():
        if outcome == "response":
            future._set_response(_response(module))
        else:
            future._set_error(failure)

    thread = threading.Thread(target=complete)
    thread.start()
    thread.join(timeout=10)
    assert not thread.is_alive()
    if add_after:
        future.add_done_callback(callback)
    error = future.error()
    seen["error_done"] = None if error is None else (type(error), str(error))
    seen["calls"] = [
        (on_main, done, None if err is None else str(err))
        for on_main, done, err in seen["calls"]
    ]
    return seen


@pytest.mark.parametrize("outcome", ["response", "error"])
@pytest.mark.parametrize("add_after", [False, True], ids=["before", "after"])
def test_same_observations_as_jax(outcome, add_after):
    port = _scenario(port_server, outcome, add_after)
    jax = _scenario(jax_server, outcome, add_after)
    assert port == jax
    assert port["error_pending"] is None
    assert len(port["calls"]) == 1
    # Before completion: runs on the completing thread; after: at once, on
    # the caller's.
    assert port["calls"][0][0] is add_after
    if outcome == "error":
        assert port["error_done"] == (ValueError, "boom")
    else:
        assert port["error_done"] is None


@pytest.mark.parametrize("name", list(MODULES))
def test_many_callbacks_each_run_once_under_a_racing_completion(name):
    module = MODULES[name]
    for _ in range(50):
        future = module.ServeFuture(1)
        counts = [0] * 8
        start = threading.Barrier(2)

        def add_all():
            start.wait(timeout=10)
            for i in range(8):
                future.add_done_callback(
                    lambda f, i=i: counts.__setitem__(i, counts[i] + 1))

        adder = threading.Thread(target=add_all)
        adder.start()
        start.wait(timeout=10)
        future._set_response(_response(module))
        adder.join(timeout=10)
        assert not adder.is_alive()
        assert counts == [1] * 8


class _Predictor(AbstractPredictor):
    def __init__(self):
        self.fail = False

    def predict(self, features):
        if self.fail:
            raise RuntimeError("predict failed")
        return {"y": np.asarray(features["x"]) * 2.0}

    def get_feature_specification(self):
        return TensorSpecStruct(
            x=ExtendedTensorSpec(shape=(3,), dtype=np.float32, name="x")
        )

    def restore(self, is_async=False):
        return True

    model_version = 0
    global_step = 0
    model_path = None


def test_a_raising_callback_does_not_stop_the_server():
    predictor = _Predictor()
    with PolicyServer(predictor, max_wait_ms=1).start() as server:
        seen = []
        done = threading.Event()

        def raising(future):
            seen.append(future.error())
            raise RuntimeError("callback bug")

        first = server.submit({"x": np.ones(3, np.float32)})
        first.add_done_callback(raising)
        first.result(timeout=30)
        # The dispatcher serves on, and failures reach callbacks typed.
        predictor.fail = True
        failed = server.submit({"x": np.ones(3, np.float32)})
        failed.add_done_callback(lambda f: (seen.append(f.error()), done.set()))
        assert done.wait(timeout=30)
        assert isinstance(failed.error(), PredictFailed)
        predictor.fail = False
        reply = server.call({"x": np.full(3, 2.0, np.float32)})
        np.testing.assert_array_equal(reply.outputs["y"], [4.0] * 3)
    assert seen[0] is None and isinstance(seen[1], PredictFailed)
