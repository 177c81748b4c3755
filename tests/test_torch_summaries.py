"""The summary keywords of the training API (ROADMAP.md D9), in both
packages: `train_eval_model.use_tensorboard`, the model's `use_summaries`
(None: off on "tpu", on otherwise) and `MetricsWriter(use_tensorboard=)`.

Each keyword is bound through the registry of each package by the same
gin text and two mock train steps run; the `metrics.jsonl` files hold the
same steps and keys. The port writes no TensorBoard events: it keeps
`metrics.jsonl` alone, which is the JAX package's behaviour when flax's
TensorFlow writer does not import. JAX's writer is never asked for
events here (importing TensorFlow takes tens of seconds).

About 5 s on the CPU.
"""

import json
import os

import pytest

from tensor2robot_tpu_torch import config as port_cfg
from tensor2robot_tpu_torch.train.metrics import MetricsWriter

# Keys whose values are wall-clock readings, not the step's numbers.
CLOCK_KEYS = {"wall_time", "steps_per_sec"}
# case -> (gin bindings, the model's use_summaries, the writer's
# use_tensorboard as train_eval_model resolves it).
CASES = {
    "use_summaries": (["MockT2RModel.use_summaries = False"], False, False),
    "use_tensorboard": (["MockT2RModel.use_summaries = True",
                         "train_eval_model.use_tensorboard = False"], True, False),
}


def _registries():
    import tensor2robot_tpu.config as jax_cfg
    import tensor2robot_tpu.config.defaults  # noqa: F401 — registers the API
    import tensor2robot_tpu_torch.config.defaults  # noqa: F401

    return {"jax": jax_cfg, "port": port_cfg}


def _records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("case", list(CASES))
def test_each_keyword_binds_in_both_packages(case, tmp_path, monkeypatch):
    bindings, summaries, resolved = CASES[case]
    records, asked = {}, {}
    for name, registry in _registries().items():
        writer_cls = registry.get_configurable("train_eval_model").__wrapped__.__globals__[
            "MetricsWriter"]
        seen = []

        class Recording(writer_cls):
            def __init__(self, log_dir, *args, use_tensorboard=False, **kwargs):
                seen.append((os.path.basename(log_dir), use_tensorboard))
                super().__init__(log_dir, *args, use_tensorboard=use_tensorboard, **kwargs)

        globals_ = registry.get_configurable("train_eval_model").__wrapped__.__globals__
        monkeypatch.setitem(globals_, "MetricsWriter", Recording)
        registry.clear_config()
        try:
            registry.parse_config("\n".join(bindings + ["MockT2RModel.device_type = 'cpu'"]))
            model = registry.get_configurable("MockT2RModel")()
            assert model.use_summaries is summaries
            generator = registry.get_configurable("MockInputGenerator")(batch_size=2)
            model_dir = str(tmp_path / name)
            registry.get_configurable("train_eval_model")(
                t2r_model=model, input_generator_train=generator, model_dir=model_dir,
                max_train_steps=2, save_checkpoints_steps=2, log_every_steps=1,
                **({"device": "cpu"} if name == "port" else {}))
        finally:
            registry.clear_config()
        records[name] = _records(os.path.join(model_dir, "train", "metrics.jsonl"))
        asked[name] = seen
    assert asked["port"] == asked["jax"] == [("train", resolved)]
    assert [r["step"] for r in records["port"]] == [r["step"] for r in records["jax"]] == [1, 2]
    for got, want in zip(records["port"], records["jax"]):
        assert set(got) - CLOCK_KEYS == set(want) - CLOCK_KEYS


@pytest.mark.parametrize("use_tensorboard", [True, False])
def test_the_port_writer_keeps_metrics_jsonl_alone(tmp_path, use_tensorboard):
    """MetricsWriter takes use_tensorboard as JAX's does and writes the
    same JSONL lines either way, nothing beside them."""
    from tensor2robot_tpu.train.metrics import MetricsWriter as JaxWriter

    port = MetricsWriter(str(tmp_path / "port"), use_tensorboard=use_tensorboard)
    jax = JaxWriter(str(tmp_path / "jax"), use_tensorboard=False)
    for writer in (port, jax):
        writer.write(3, {"loss": 0.5, "accuracy": 1})
        writer.close()
    assert os.listdir(tmp_path / "port") == ["metrics.jsonl"]
    got, = _records(str(tmp_path / "port" / "metrics.jsonl"))
    want, = _records(str(tmp_path / "jax" / "metrics.jsonl"))
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k != "wall_time"} == {
        k: v for k, v in want.items() if k != "wall_time"}


@pytest.mark.parametrize("device_type,summaries", [("tpu", False), ("cpu", True),
                                                   ("gpu", True)])
def test_use_summaries_defaults_as_jaxs(device_type, summaries):
    from tensor2robot_tpu.utils.mocks import MockT2RModel as JaxMock
    from tensor2robot_tpu_torch.utils.mocks import MockT2RModel

    assert MockT2RModel(device_type=device_type).use_summaries is summaries
    assert JaxMock(device_type=device_type).use_summaries is summaries
    assert MockT2RModel(device_type=device_type, use_summaries=not summaries).use_summaries \
        is (not summaries)
