"""The port's serving path: PolicyServer over CheckpointPredictor on CPU.

Replies from the micro-batching server must equal a direct predict of the
same episode; the server's admission, deadline, failure and watchdog
semantics, the bucket helpers and the T2R_SERVE_* flags follow the JAX
package's (tensor2robot_tpu/serving, tensor2robot_tpu/flags.py).
"""

import threading
import time

import numpy as np
import pytest
import torch

from tensor2robot_tpu import flags as jax_flags
from tensor2robot_tpu.serving import buckets as jax_buckets
from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.models.transformer_models import TransformerBCModel
from tensor2robot_tpu_torch.predictors import (
    AbstractPredictor,
    CheckpointPredictor,
    latest_checkpoint_step,
    save_checkpoint,
)
from tensor2robot_tpu_torch.serving import (
    DeadlineExceeded,
    PolicyServer,
    PredictFailed,
    PredictTimeout,
    RequestRejected,
    RequestShed,
    ServerClosed,
)
from tensor2robot_tpu_torch.serving import buckets
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    make_random_numpy,
)

# Batched vs single-episode predict on the CPU: f32 sums over the same
# rows, grouped differently by the batch size.
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _model():
    return TransformerBCModel(
        action_size=7, pose_size=14, episode_length=16, image_size=(16, 16),
        d_model=32, num_layers=2, num_heads=2, head_dim=16, use_flash=True,
    )


@pytest.fixture(scope="module")
def predictor():
    pred = CheckpointPredictor(_model(), device="cpu")
    pred.init_randomly(torch.Generator().manual_seed(4))
    return pred


@pytest.fixture(scope="module")
def episodes(predictor):
    batch = make_random_numpy(
        predictor.get_feature_specification(), batch_size=5, seed=6
    )
    return [{k: v[i] for k, v in batch.items()} for i in range(5)]


class TestServedRepliesMatchPredict:
    def test_threaded_clients(self, predictor, episodes):
        direct = [
            predictor.predict({k: v[None] for k, v in ep.items()})["action"][0]
            for ep in episodes
        ]
        replies = {}

        def client(i):
            replies[i] = server.call(episodes[i % 5], timeout=60)

        with PolicyServer(
            predictor, batch_buckets=(1, 2, 4), max_wait_ms=30,
            default_deadline_ms=60_000,
        ).start() as server:
            threads = [threading.Thread(target=client, args=(i,)) for i in range(10)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            snap = server.snapshot()
        assert not any(t.is_alive() for t in threads)
        assert len(replies) == 10
        for i, response in replies.items():
            assert response.model_version == 0
            assert response.outputs["action"].shape == (16, 7)
            np.testing.assert_allclose(
                response.outputs["action"], direct[i % 5], rtol=TOL, atol=TOL
            )
        assert snap["counters"]["completed"] == 10
        assert snap["counters"]["failed"] == 0
        assert set(snap["batches_by_bucket"]) <= {"1", "2", "4"}
        assert snap["buckets"] == [1, 2, 4]

    def test_float64_requests_are_coerced(self, predictor, episodes):
        request = {k: v.astype(np.float64) for k, v in episodes[0].items()}
        with PolicyServer(predictor, max_wait_ms=1).start(prewarm=False) as server:
            reply = server.call(request, timeout=60)
        want = predictor.predict({k: v[None] for k, v in episodes[0].items()})
        np.testing.assert_allclose(reply.outputs["action"], want["action"][0], rtol=TOL, atol=TOL)

    def test_wrong_shape_rejected_on_submit(self, predictor, episodes):
        bad = dict(episodes[0])
        bad["image"] = bad["image"][None]
        with PolicyServer(predictor, max_wait_ms=1).start(prewarm=False) as server:
            with pytest.raises(ValueError, match="one example"):
                server.submit(bad)
            with pytest.raises(ValueError, match="missing"):
                server.submit({"image": episodes[0]["image"]})


class _GatedPredictor(AbstractPredictor):
    """A one-feature predictor whose predict waits on `gate` and can fail."""

    def __init__(self, fail=False, hang=False):
        self.gate = threading.Event()
        self.fail, self.hang = fail, hang
        self.calls = 0

    def predict(self, features):
        self.calls += 1
        if self.hang:
            self.gate.wait(10)
        if self.fail:
            raise RuntimeError("boom")
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


def _x(value=1.0):
    return {"x": np.full((3,), value, np.float32)}


class TestServerSemantics:
    def test_prewarm_runs_every_bucket(self):
        pred = _GatedPredictor()
        with PolicyServer(pred, batch_buckets=(1, 2, 4)).start():
            assert pred.calls == 3

    def test_reply_rows(self):
        with PolicyServer(_GatedPredictor(), max_wait_ms=1).start() as server:
            np.testing.assert_array_equal(server.call(_x(3.0)).outputs["y"], [6.0] * 3)

    def test_shed_oldest(self):
        pred = _GatedPredictor(hang=True)
        server = PolicyServer(
            pred, max_queue=1, max_wait_ms=0, overload="shed_oldest"
        ).start(prewarm=False)
        try:
            first = server.submit(_x())
            deadline = time.monotonic() + 10
            while pred.calls == 0 and time.monotonic() < deadline:
                time.sleep(0.005)  # the dispatcher holds `first` in predict
            second = server.submit(_x())
            third = server.submit(_x())
            with pytest.raises(RequestShed):
                second.result(10)
            pred.gate.set()
            first.result(10)
            third.result(10)
            assert server.snapshot()["counters"]["shed"] == 1
        finally:
            pred.gate.set()
            server.stop()

    def test_reject(self):
        pred = _GatedPredictor(hang=True)
        server = PolicyServer(
            pred, max_queue=1, max_wait_ms=0, overload="reject"
        ).start(prewarm=False)
        try:
            server.submit(_x())
            deadline = time.monotonic() + 10
            while pred.calls == 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            server.submit(_x())
            with pytest.raises(RequestRejected):
                server.submit(_x())
            assert server.snapshot()["counters"]["rejected"] == 1
        finally:
            pred.gate.set()
            server.stop()

    def test_deadline_exceeded(self):
        pred = _GatedPredictor(hang=True)
        server = PolicyServer(pred, max_wait_ms=0).start(prewarm=False)
        try:
            blocker = server.submit(_x())
            deadline = time.monotonic() + 10
            while pred.calls == 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            late = server.submit(_x(), deadline_ms=1)
            time.sleep(0.05)
            pred.gate.set()
            blocker.result(10)
            with pytest.raises(DeadlineExceeded):
                late.result(10)
            assert server.snapshot()["counters"]["deadline_missed"] == 1
        finally:
            pred.gate.set()
            server.stop()

    def test_predict_failure_is_typed_and_the_loop_lives(self):
        pred = _GatedPredictor(fail=True)
        with PolicyServer(pred, max_wait_ms=1).start(prewarm=False) as server:
            with pytest.raises(PredictFailed) as info:
                server.call(_x())
            assert info.value.failure_class == "RuntimeError"
            pred.fail = False
            server.call(_x())
            snap = server.snapshot()
        assert snap["failed_by_class"] == {"RuntimeError": 1}
        assert snap["counters"]["completed"] == 1

    def test_watchdog(self):
        pred = _GatedPredictor(hang=True)
        with PolicyServer(
            pred, max_wait_ms=1, predict_timeout_ms=50
        ).start(prewarm=False) as server:
            with pytest.raises(PredictTimeout):
                server.call(_x())
            pred.gate.set()
            assert server.snapshot()["failed_by_class"] == {"PredictTimeout": 1}

    def test_stop_without_drain(self):
        pred = _GatedPredictor(hang=True)
        server = PolicyServer(pred, max_wait_ms=0).start(prewarm=False)
        blocker = server.submit(_x())
        deadline = time.monotonic() + 10
        while pred.calls == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        queued = server.submit(_x())
        stopper = threading.Thread(target=server.stop, kwargs=dict(drain=False))
        stopper.start()
        with pytest.raises(ServerClosed):
            queued.result(10)
        pred.gate.set()
        blocker.result(10)
        stopper.join(10)
        assert not stopper.is_alive()
        with pytest.raises(RuntimeError, match="not started"):
            server.submit(_x())

    def test_bad_overload_policy(self):
        with pytest.raises(ValueError, match="overload"):
            PolicyServer(_GatedPredictor(), overload="drop")


class TestBuckets:
    @pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
    def test_pick_and_pad_match_jax(self, n):
        ladder = (1, 2, 4, 8)
        assert buckets.pick_bucket(ladder, n) == jax_buckets.pick_bucket(ladder, n)
        rows = [{"a": np.full((2,), i, np.float32)} for i in range(n)]
        bucket = buckets.pick_bucket(ladder, n)
        np.testing.assert_array_equal(
            buckets.pad_feature_batch(rows, bucket)["a"],
            jax_buckets.pad_feature_batch(rows, bucket)["a"],
        )

    def test_resolution_order(self, monkeypatch):
        monkeypatch.delenv("T2R_SERVE_BUCKETS", raising=False)
        assert buckets.resolve_buckets(None) == (1,)
        monkeypatch.setenv("T2R_SERVE_BUCKETS", "4, 1,2")
        assert buckets.resolve_buckets(None) == (1, 2, 4)
        assert buckets.resolve_buckets([8, 8, 3]) == (3, 8)
        monkeypatch.setenv("T2R_SERVE_BUCKETS", "x")
        with pytest.raises(ValueError, match="comma-separated"):
            buckets.resolve_buckets(None)
        with pytest.raises(ValueError, match="positive"):
            buckets.resolve_buckets([0])
        with pytest.raises(ValueError, match="exceeds"):
            buckets.pick_bucket((1, 2), 3)


class TestFlags:
    def test_declarations_match_jax(self):
        # The one stated divergence: the port builds no AOT packages unless
        # asked (an AOTInductor build takes tens of seconds a bucket).
        diverging = {"T2R_AOT_EXPORT": (False, True)}
        for spec in flags.all_flags():
            theirs = jax_flags.get_flag(spec.name)
            expected = diverging.get(spec.name, (theirs.default, theirs.default))
            assert (spec.default, theirs.default) == expected, spec.name
            assert (spec.kind, spec.choices, spec.minimum) == (
                theirs.kind, theirs.choices, theirs.minimum
            )

    def test_getters(self, monkeypatch):
        monkeypatch.setenv("T2R_SERVE_MAX_QUEUE", "0")
        assert flags.get_int("T2R_SERVE_MAX_QUEUE") == 1  # clamped
        monkeypatch.setenv("T2R_SERVE_MAX_QUEUE", "many")
        with pytest.raises(ValueError, match="integer"):
            flags.get_int("T2R_SERVE_MAX_QUEUE")
        monkeypatch.setenv("T2R_SERVE_OVERLOAD", "drop")
        with pytest.raises(ValueError, match="expected"):
            flags.get_enum("T2R_SERVE_OVERLOAD")
        with pytest.raises(KeyError, match="not a declared"):
            flags.get_int("T2R_NOPE")
        with pytest.raises(TypeError):
            flags.get_str("T2R_SERVE_MAX_QUEUE")


class TestCheckpoints:
    def test_restore_newest_and_hot_swap(self, tmp_path, episodes):
        model = _model()
        nets = [
            model.init_network(torch.Generator().manual_seed(s), "cpu")
            for s in (1, 2)
        ]
        save_checkpoint(str(tmp_path), 3, nets[0].state_dict())
        (tmp_path / "checkpoints" / "9.pt.123.tmp").write_bytes(b"torn")
        assert latest_checkpoint_step(str(tmp_path)) == 3
        pred = CheckpointPredictor(model, checkpoint_dir=str(tmp_path), device="cpu")
        request = {k: v[None] for k, v in episodes[0].items()}
        with PolicyServer(pred, max_wait_ms=1).start(prewarm=False) as server:
            assert pred.model_version == 3
            first = server.call(episodes[0])
            save_checkpoint(str(tmp_path), 7, nets[1].state_dict())
            assert server.hot_swap(wait=True)
            second = server.call(episodes[0])
        assert (first.model_version, second.model_version) == (3, 7)
        assert pred.model_path == str(tmp_path / "checkpoints" / "7.pt")
        reference = CheckpointPredictor(model, device="cpu")
        reference.load_state_dict(nets[1].state_dict(), version=7)
        np.testing.assert_allclose(
            second.outputs["action"], reference.predict(request)["action"][0],
            rtol=TOL, atol=TOL,
        )

    def test_restore_times_out_on_empty_dir(self, tmp_path):
        pred = CheckpointPredictor(
            _model(), checkpoint_dir=str(tmp_path), timeout=0, device="cpu"
        )
        assert pred.restore() is False
        with pytest.raises(ValueError, match="no model loaded"):
            pred.predict({})


class TestExportLadder:
    CASES = {
        "argument": dict(explicit=[8, 3], flag="2,1", meta=[1, 4]),
        "flag": dict(explicit=None, flag="2,1", meta=[1, 4]),
        "metadata": dict(explicit=None, flag=None, meta=[4, 1, 2]),
        "default": dict(explicit=None, flag=None, meta=[]),
        "no_metadata": dict(explicit=None, flag=None, meta=None),
    }

    @pytest.mark.parametrize("case", list(CASES))
    def test_resolution_order_matches_jax(self, monkeypatch, case):
        """argument > T2R_SERVE_BUCKETS > the export's warmup_batch_sizes
        > (1,), as the JAX package resolves it."""
        kw = self.CASES[case]
        monkeypatch.delenv("T2R_SERVE_BUCKETS", raising=False)
        if kw["flag"] is not None:
            monkeypatch.setenv("T2R_SERVE_BUCKETS", kw["flag"])
        metadata = None if kw["meta"] is None else {"warmup_batch_sizes": kw["meta"]}
        got = buckets.resolve_buckets(kw["explicit"], metadata)
        assert got == jax_buckets.resolve_buckets(kw["explicit"], metadata)
        assert buckets.buckets_from_metadata(metadata) == (
            jax_buckets.buckets_from_metadata(metadata or {}))


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Two export versions (weights of seeds 1 and 2) with ladder (1, 2, 4)
    and warmup requests, and a reference predictor per version."""
    from tensor2robot_tpu_torch.export import (
        DefaultExportGenerator,
        save_exported_model,
    )

    model = _model()
    generator = DefaultExportGenerator()
    generator.set_specification_from_model(model)
    out = {}
    for seed in (1, 2):
        state = model.init_network(
            torch.Generator().manual_seed(seed), "cpu").state_dict()
        path = save_exported_model(
            str(tmp_path_factory.mktemp(f"v{seed}")), variables=state,
            feature_spec=generator.serving_input_spec(), global_step=seed,
            serving_module=generator.create_serving_fn(state, device=torch.device("cpu")),
            example_features=generator.create_example_features(),
            metadata={"warmup_batch_sizes": [1, 2, 4]},
        )
        generator.create_warmup_requests_numpy((1, 2, 4), path)
        reference = CheckpointPredictor(_model(), device="cpu")
        reference.load_state_dict(state)
        out[seed] = (path, reference)
    return out


def _install(exports, root, seed, version):
    import os
    import shutil

    tmp = os.path.join(root, f"temp-{version}")
    shutil.copytree(exports[seed][0], tmp)
    os.replace(tmp, os.path.join(root, str(version)))


class TestServingExports:
    def test_ladder_and_warmup_batches_come_from_the_export(self, exports, tmp_path,
                                                            monkeypatch):
        from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor

        monkeypatch.delenv("T2R_SERVE_BUCKETS", raising=False)
        _install(exports, tmp_path, 1, 10)
        predictor = ExportedSavedModelPredictor(str(tmp_path), device="cpu")
        seen = []
        original = predictor.predict

        def spy(features):
            seen.append({k: np.array(v) for k, v in features.items()})
            return original(features)

        predictor.predict = spy
        with PolicyServer(predictor) as server:
            server.start()
            assert server.buckets == (1, 2, 4)
            snap = server.snapshot()
            assert snap["warmup_source"] == "export"
            assert snap["prewarmed"] == {"10": [1, 2, 4]}
        warmup = buckets.load_warmup_batches(
            exports[1][0], predictor.get_feature_specification(),
            {"warmup_batch_sizes": [1, 2, 4]})
        assert [s["gripper_pose"].shape[0] for s in seen] == [1, 2, 4]
        for batch, size in zip(seen, (1, 2, 4)):
            for key in batch:
                np.testing.assert_array_equal(batch[key], warmup[size][key])

    def test_missing_warmup_file_synthesizes(self, exports, tmp_path, monkeypatch):
        import shutil

        from tensor2robot_tpu_torch.predictors import ExportedSavedModelPredictor

        monkeypatch.delenv("T2R_SERVE_BUCKETS", raising=False)
        _install(exports, tmp_path, 1, 10)
        shutil.rmtree(tmp_path / "10" / "warmup")
        predictor = ExportedSavedModelPredictor(str(tmp_path), device="cpu")
        with PolicyServer(predictor, batch_buckets=(2,)) as server:
            server.start()
            assert server.buckets == (2,)
            assert server.snapshot()["warmup_source"] == "synthesized"

    def test_hot_swap_under_traffic(self, exports, tmp_path, monkeypatch):
        """Clients keep sending while version 20 lands: every reply comes
        from version 10 or 20, a client never sees the version go back,
        each reply equals its own version's predict, the last replies are
        20, and version 20 ran every bucket before it served."""
        from tensor2robot_tpu_torch.predictors import (
            ExportedSavedModelPredictor,
            exported_savedmodel_predictor,
        )

        monkeypatch.delenv("T2R_SERVE_BUCKETS", raising=False)
        monkeypatch.setattr(exported_savedmodel_predictor, "POLL_SECONDS", 0.05)
        _install(exports, tmp_path, 1, 10)
        predictor = ExportedSavedModelPredictor(str(tmp_path), device="cpu")
        spec_batch = make_random_numpy(_model().preprocessor.get_in_feature_specification(
            "predict"), batch_size=3, seed=9)
        requests = [{k: v[i] for k, v in spec_batch.items()} for i in range(3)]
        expected = {version: exports[seed][1].predict(dict(spec_batch.items()))["action"]
                    for version, seed in ((10, 1), (20, 2))}
        replies = {i: [] for i in range(3)}
        errors, stop = [], threading.Event()
        swapped_at = []

        def client(index):
            try:
                while not stop.is_set() or not swapped_at or (
                        len(replies[index]) < 3 + swapped_at[0][index]):
                    response = server.call(requests[index], timeout=60)
                    replies[index].append(response)
            except Exception as err:  # noqa: BLE001 — reported below
                errors.append(err)

        with PolicyServer(predictor, max_wait_ms=2) as server:
            server.start()
            threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
            for thread in threads:
                thread.start()
            while min(len(r) for r in replies.values()) < 2 and not errors:
                time.sleep(0.01)
            _install(exports, tmp_path, 2, 20)
            assert server.hot_swap()
            deadline = time.monotonic() + 60
            while predictor.model_version != 20 and time.monotonic() < deadline:
                time.sleep(0.01)
            swapped_at.append({i: len(r) for i, r in replies.items()})
            stop.set()
            for thread in threads:
                thread.join(timeout=120)
            snap = server.snapshot()
        assert not errors and predictor.model_version == 20
        assert snap["prewarmed"] == {"10": [1, 2, 4], "20": [1, 2, 4]}
        assert snap["counters"]["hot_swaps"] == 1
        for index, rows in replies.items():
            versions = [r.model_version for r in rows]
            assert set(versions) <= {10, 20} and versions == sorted(versions)
            assert versions[0] == 10 and versions[-1] == 20
            for response in rows:
                np.testing.assert_allclose(
                    response.outputs["action"], expected[response.model_version][index],
                    atol=TOL, rtol=TOL)
