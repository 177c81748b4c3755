"""Input generators: the bridge from models' specs to batched data streams.

An input generator holds a batch size and (after
`set_specification_from_model`) the feature/label specs pulled from the
model's preprocessor; `create_dataset` then yields numpy batches packed as
{features, labels}. Port of tensor2robot_tpu/data/input_generators.py:
the same seed gives byte-identical batches. Generators yield host
batches; the trainer copies them to the card (train/infeed.py).

The record generators read TFRecord shards through RecordDataset
(data/dataset.py), and `set_specification_from_model` captures the
preprocessor's decode-time crops (`get_decode_rois(mode)`) so the dataset
decodes only the crop window (data/roi.py; T2R_DECODE_ROI=0 restores
full frames).
"""

from __future__ import annotations

import abc
import itertools
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence, Union

import numpy as np

from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.data.dataset import RecordDataset, weighted_interleave
from tensor2robot_tpu_torch.specs import (
    TensorSpecStruct,
    make_constant_numpy,
    make_random_numpy,
    validate_and_pack,
)

MODE_TRAIN = "train"
MODE_EVAL = "eval"
MODE_PREDICT = "predict"
ALL_MODES = (MODE_TRAIN, MODE_EVAL, MODE_PREDICT)


class AbstractInputGenerator(abc.ABC):
    """Holds batch size + specs; produces mode-bound batch iterators."""

    def __init__(self, batch_size: int = 32):
        self._batch_size = batch_size
        self._feature_spec: Optional[TensorSpecStruct] = None
        self._label_spec: Optional[TensorSpecStruct] = None
        # {mode: {combined-spec key: DecodeROI}} from the preprocessor.
        self._decode_rois_by_mode: Dict[str, Any] = {}

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def feature_spec(self) -> TensorSpecStruct:
        if self._feature_spec is None:
            raise ValueError(
                "Specs not set; call set_specification_from_model first."
            )
        return self._feature_spec

    def set_specification_from_model(self, model: Any, mode: str) -> None:
        """Pulls the *in* specs off the model's preprocessor: the data must
        match what the preprocessor consumes."""
        preprocessor = model.preprocessor
        self._feature_spec = preprocessor.get_in_feature_specification(mode)
        self._label_spec = preprocessor.get_in_label_specification(mode)
        # The preprocessor's crop becomes the dataset's decode window, under
        # the combined "features/..." keys the dataset parses.
        get_rois = getattr(preprocessor, "get_decode_rois", None)
        rois = get_rois(mode) if callable(get_rois) else None
        self._decode_rois_by_mode[mode] = (
            {f"features/{key}": roi for key, roi in rois.items()} if rois else None
        )

    def set_specification(
        self, feature_spec: TensorSpecStruct,
        label_spec: Optional[TensorSpecStruct],
    ) -> None:
        self._feature_spec = feature_spec
        self._label_spec = label_spec
        self._decode_rois_by_mode = {}

    def decode_rois(self, mode: str):
        """The decode-time ROI map captured for `mode`, or None."""
        return self._decode_rois_by_mode.get(mode)

    def combined_spec(self) -> TensorSpecStruct:
        spec = TensorSpecStruct()
        for key, value in self.feature_spec.items():
            spec[f"features/{key}"] = value
        if self._label_spec is not None:
            for key, value in self._label_spec.items():
                spec[f"labels/{key}"] = value
        return spec

    def create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        """Yields batches packed as struct with 'features/...' and
        'labels/...' subtrees."""
        if mode not in ALL_MODES:
            raise ValueError(f"mode must be one of {ALL_MODES}, got {mode!r}")
        return self._create_dataset(mode)

    @abc.abstractmethod
    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        ...


class DefaultRecordInputGenerator(AbstractInputGenerator):
    """Reads TFRecord shards by glob patterns or a dataset_map."""

    def __init__(
        self,
        file_patterns: Optional[Union[str, Sequence[str]]] = None,
        dataset_map: Optional[Mapping[str, Union[str, Sequence[str]]]] = None,
        batch_size: int = 32,
        shuffle_buffer_size: int = 512,
        seed: Optional[int] = None,
        file_fraction: float = 1.0,
        prefetch_depth: int = 2,
        num_parse_workers: Optional[int] = None,
        shard_by_host: bool = False,
    ):
        super().__init__(batch_size=batch_size)
        if (file_patterns is None) == (dataset_map is None):
            raise ValueError("Provide exactly one of file_patterns or dataset_map.")
        self._file_patterns = dataset_map if dataset_map is not None else file_patterns
        self._shuffle_buffer_size = shuffle_buffer_size
        self._seed = seed
        self._file_fraction = file_fraction
        self._prefetch_depth = prefetch_depth
        self._num_parse_workers = num_parse_workers
        self._shard_by_host = shard_by_host
        self._data_shard = None

    @property
    def shard_by_host(self) -> bool:
        """Whether each process of the group reads only its slice of the
        files (RecordDataset)."""
        return self._shard_by_host

    def set_data_shard(self, index: int, count: int) -> None:
        """With shard_by_host, read data x fsdp shard `index` of `count`
        (the trainer sets it from its mesh): the files split by it, and
        batches of batch_size / count records."""
        self._data_shard = (int(index), int(count))

    def create_record_dataset(self, mode: str) -> RecordDataset:
        return RecordDataset(
            specs=self.combined_spec(),
            file_patterns=self._file_patterns,
            batch_size=self._batch_size,
            mode=mode,
            shuffle_buffer_size=self._shuffle_buffer_size,
            seed=self._seed,
            file_fraction=self._file_fraction,
            prefetch_depth=self._prefetch_depth,
            num_parse_workers=self._num_parse_workers,
            decode_roi=self.decode_rois(mode),
            shard_by_host=self._shard_by_host,
            data_shard=self._data_shard,
        )

    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        return iter(self.create_record_dataset(mode))


class FractionalRecordInputGenerator(DefaultRecordInputGenerator):
    """Data ablation by file fraction."""

    def __init__(self, file_fraction: float, **kwargs):
        kwargs["file_fraction"] = file_fraction
        super().__init__(**kwargs)


class MultiEvalRecordInputGenerator(DefaultRecordInputGenerator):
    """Picks the eval dataset by eval name (argument or
    T2R_MULTI_EVAL_NAME) from a map of datasets."""

    def __init__(
        self,
        eval_dataset_map: Mapping[str, Union[str, Sequence[str]]],
        eval_name: Optional[str] = None,
        **kwargs,
    ):
        eval_name = eval_name or flags.get_str("T2R_MULTI_EVAL_NAME")
        if not eval_name:
            raise ValueError(
                "MultiEvalRecordInputGenerator requires eval_name (arg or "
                "T2R_MULTI_EVAL_NAME env)."
            )
        if eval_name not in eval_dataset_map:
            raise ValueError(
                f"eval_name {eval_name!r} not in {sorted(eval_dataset_map)}"
            )
        super().__init__(file_patterns=eval_dataset_map[eval_name], **kwargs)
        self.eval_name = eval_name


def create_multi_eval_generators(
    eval_dataset_map: Mapping[str, Union[str, Sequence[str]]],
    **kwargs,
) -> Dict[str, MultiEvalRecordInputGenerator]:
    """One MultiEvalRecordInputGenerator per named eval dataset: the map
    form train_eval_model evaluates as named evals."""
    return {
        name: MultiEvalRecordInputGenerator(eval_dataset_map, eval_name=name, **kwargs)
        for name in eval_dataset_map
    }


class WeightedRecordInputGenerator(AbstractInputGenerator):
    """Samples batches from several record sources with given weights."""

    def __init__(
        self,
        file_patterns: Sequence[Union[str, Sequence[str]]],
        weights: Optional[Sequence[float]] = None,
        batch_size: int = 32,
        seed: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(batch_size=batch_size)
        self._sources = list(file_patterns)
        self._weights = list(weights) if weights else [1.0] * len(self._sources)
        if len(self._weights) != len(self._sources):
            raise ValueError("weights and file_patterns must align")
        self._seed = seed
        self._kwargs = kwargs

    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        datasets = [
            RecordDataset(
                specs=self.combined_spec(),
                file_patterns=patterns,
                batch_size=self._batch_size,
                mode=mode,
                seed=self._seed,
                decode_roi=self.decode_rois(mode),
                **self._kwargs,
            )
            for patterns in self._sources
        ]
        return weighted_interleave(datasets, self._weights, seed=self._seed)


class GeneratorInputGenerator(AbstractInputGenerator):
    """Batches from a user python generator producing per-example dicts
    keyed like the combined spec; a short last batch is dropped."""

    def __init__(
        self,
        generator_fn: Callable[[], Iterator[Mapping[str, np.ndarray]]],
        batch_size: int = 32,
    ):
        super().__init__(batch_size=batch_size)
        self._generator_fn = generator_fn

    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        source = self._generator_fn()
        while True:
            rows = list(itertools.islice(source, self._batch_size))
            if len(rows) < self._batch_size:
                return
            batch = TensorSpecStruct()
            for key in rows[0].keys():
                batch[key] = np.stack([np.asarray(r[key]) for r in rows])
            yield validate_and_pack(self.combined_spec(), batch, ignore_batch=True)


class DefaultRandomInputGenerator(AbstractInputGenerator):
    """Spec-conforming random batches, batch i drawn from seed + i: a
    data-free source for tests and bring-up."""

    def __init__(self, batch_size: int = 32, sequence_length: int = 3, seed: int = 0):
        super().__init__(batch_size=batch_size)
        self._sequence_length = sequence_length
        self._seed = seed

    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        for step in itertools.count():
            yield make_random_numpy(
                self.combined_spec(),
                batch_size=self._batch_size,
                sequence_length=self._sequence_length,
                seed=self._seed + step,
            )


class DefaultConstantInputGenerator(AbstractInputGenerator):
    """Spec-conforming constant batches."""

    def __init__(self, constant_value: float, batch_size: int = 32, sequence_length: int = 3):
        super().__init__(batch_size=batch_size)
        self._constant_value = constant_value
        self._sequence_length = sequence_length

    def _create_dataset(self, mode: str) -> Iterator[TensorSpecStruct]:
        while True:
            yield make_constant_numpy(
                self.combined_spec(),
                constant_value=self._constant_value,
                batch_size=self._batch_size,
                sequence_length=self._sequence_length,
            )
