"""Replay writers: episode sinks for the collect/eval loop.

Port of tensor2robot_tpu/utils/writer.py. TFRecordReplayWriter appends
serialized tf.Example transitions to sharded TFRecord files through the
port's TFRecord writer (data/tfrecord.py) — the robot-side half of the
filesystem data bus the learner reads.
"""

from __future__ import annotations

import abc
import datetime
import os
import time
from typing import Optional, Sequence, Union

from tensor2robot_tpu_torch.config import configurable
from tensor2robot_tpu_torch.data.tfrecord import TFRecordWriter


class ReplayWriter(abc.ABC):
    """open/write/close episode-sink contract."""

    @abc.abstractmethod
    def open(self, path: str) -> None:
        ...

    @abc.abstractmethod
    def write(self, serialized_records: Union[bytes, Sequence[bytes]]) -> None:
        ...

    @abc.abstractmethod
    def close(self) -> None:
        ...


def timestamped_record_path(
    output_dir: str, global_step: int, suffix: str = ""
) -> str:
    """The shard-naming convention learners glob for:
    <output_dir>/gs<step>_<timestamp>[_<suffix>]."""
    timestamp = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    name = f"gs{global_step}_{timestamp}"
    if suffix:
        name = f"{name}_{suffix}"
    return os.path.join(output_dir, name)


def serialize_transition_records(records) -> list:
    """Records -> bytes for the replay writer; passes bytes through and
    rejects anything else with a clear error (the port writes Examples as
    bytes, data/encoder.py; objects with SerializeToString also pass)."""
    out = []
    for record in records:
        if isinstance(record, (bytes, bytearray)):
            out.append(bytes(record))
        elif hasattr(record, "SerializeToString"):
            out.append(record.SerializeToString())
        else:
            raise ValueError(
                "Replay records must be serialized bytes or protos with "
                f"SerializeToString; got {type(record).__name__}. Supply a "
                "transition_to_record_fn or a converter producing bytes."
            )
    return out


@configurable("TFRecordReplayWriter")
class TFRecordReplayWriter(ReplayWriter):
    """Writes transition records to <path>-<timestamp>.tfrecord shards."""

    def __init__(self):
        self._writer: Optional[TFRecordWriter] = None
        self._path: Optional[str] = None

    def open(self, path: str) -> None:
        """Starts a new shard; `path` is a prefix, the shard gets a unique
        timestamp suffix so concurrent collectors never collide."""
        self.close()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        shard = f"{path}-{int(time.time() * 1e6)}.tfrecord"
        self._writer = TFRecordWriter(shard)
        self._path = shard

    @property
    def current_shard(self) -> Optional[str]:
        return self._path

    def write(self, serialized_records: Union[bytes, Sequence[bytes]]) -> None:
        if self._writer is None:
            raise ValueError("TFRecordReplayWriter.write before open().")
        if isinstance(serialized_records, (bytes, bytearray)):
            serialized_records = [serialized_records]
        for record in serialized_records:
            self._writer.write(bytes(record))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
