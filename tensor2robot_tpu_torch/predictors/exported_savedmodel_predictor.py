"""Predictor over exported model dirs: serve the newest export version.

Port of tensor2robot_tpu/predictors/exported_savedmodel_predictor.py
(without the compile cache, ROADMAP.md A10).
It loads the newest timestamped export under a root and rebuilds the input
contract from assets.extra/t2r_assets.pbtxt, so it needs no model code
when the export carries a program (export/saved_model.py). It serves the
program on `device` (the card by default) and keeps the fleet behaviours:

  * busy-wait restore with a timeout, for robots that boot before the
    learner has exported anything;
  * async restore: a background thread loads the new version while
    predict() serves the old one, and swaps on completion; a second
    request while one is in flight starts no second thread;
  * a restore prewarm hook (`set_restore_prewarm`): the policy server
    readies every bucket on the incoming version before the swap, and a
    failed prewarm keeps the old version;
  * action-tile-aware input expansion: a critic exported with an action
    population dim accepts un-tiled inputs, broadcast up on the host;
  * a low-precision serving regime (`quant_regime`, None reads
    T2R_SERVE_QUANT at every restore): every version it swaps in serves
    that regime's program and payload, and a version that lacks it fails
    the restore.

An export without a program is served from model code (`t2r_model`) and
the export's variables, under no regime: model code would serve f32
where a regime was asked for, so that raises.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from tensor2robot_tpu_torch.export.saved_model import ExportedModel, latest_export_dir
from tensor2robot_tpu_torch.predictors.abstract_predictor import AbstractPredictor
from tensor2robot_tpu_torch.predictors.saved_model_v2_predictor import (
    build_model_code_serving_fn,
    make_random_loaded,
    version_of,
)
from tensor2robot_tpu_torch.specs import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    flatten_spec_structure,
)
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


#: Seconds between polls of an export root that has no version yet.
POLL_SECONDS = 2.0


class ExportedSavedModelPredictor(AbstractPredictor):
    """Serves the newest export under `export_dir`."""

    def __init__(
        self,
        export_dir: str,
        t2r_model=None,
        timeout: float = 600,
        tile_batch_for_action: bool = True,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        quant_regime: Optional[str] = None,
    ):
        """Args:
        export_dir: root holding timestamped export versions.
        t2r_model: optional model for serving an export without a program.
        timeout: seconds restore() busy-waits for a first export.
        tile_batch_for_action: expand inputs that miss the exported
          action-population dim (CEM critics).
        device: where the program runs; 'cuda' raises without a card.
        quant_regime: the serving regime ("none", "fp16", "int8",
          "fp8_e4m3", "fp8_e5m2"); None reads T2R_SERVE_QUANT at restore.
        """
        self._export_dir = export_dir
        self._quant_regime = quant_regime
        self._t2r_model = t2r_model
        self._timeout = timeout
        self._tile = tile_batch_for_action
        self._device = resolve_device(device)
        self._loaded = None
        self._predict_fn: Optional[Callable] = None
        self._lock = threading.Lock()
        self._restore_thread: Optional[threading.Thread] = None
        # True from the moment an async restore is scheduled until its
        # thread ends: is_alive() alone leaves a window before the thread
        # starts in which a second restore(is_async=True) would start a
        # duplicate.
        self._restore_in_flight = False
        self._restore_thread_leaked = False
        self._restore_prewarm: Optional[Callable] = None

    def set_restore_prewarm(self, fn: Optional[Callable]) -> None:
        """Installs `fn(loaded, serve)` to run on every restore after the
        new version's serving fn is built and before it is swapped in;
        `serve` is the predict()-shaped view of the incoming version. A
        prewarm that raises aborts the swap: the old version serves on."""
        with self._lock:
            self._restore_prewarm = fn

    # -- restore ----------------------------------------------------------------

    def restore(self, is_async: bool = False) -> bool:
        if is_async:
            with self._lock:
                if self._restore_in_flight:
                    return True  # one is scheduled or running already
                thread = threading.Thread(
                    target=self._restore_async_target,
                    name="t2r-async-restore", daemon=True,
                )
                self._restore_in_flight = True
                self._restore_thread = thread
                # Started under the lock, and the flag cleared if start()
                # fails, so the flag and the thread stay consistent.
                try:
                    thread.start()
                except BaseException:
                    self._restore_in_flight = False
                    self._restore_thread = None
                    raise
            return True
        return self._restore_sync()

    def _restore_async_target(self) -> None:
        try:
            self._restore_sync()
        finally:
            with self._lock:
                self._restore_in_flight = False

    def _restore_sync(self) -> bool:
        start = time.monotonic()
        while True:
            path = latest_export_dir(self._export_dir)
            if path is not None:
                current = self._loaded
                if current is not None and current.export_dir == path:
                    return True
                try:
                    loaded = ExportedModel(path, device=self._device,
                                           quant_regime=self._quant_regime)
                except OSError:
                    # Raced the version GC deleting this dir between
                    # listing and reading: not yet available, poll again.
                    loaded = None
                if loaded is not None:
                    # A missing program without model code is permanent:
                    # raise instead of burning the timeout.
                    predict_fn = self._build_predict_fn(loaded)
                    prewarm = self._restore_prewarm
                    if prewarm is not None:
                        try:
                            prewarm(loaded, self._serving_callable(loaded, predict_fn))
                        except Exception:  # noqa: BLE001 — a version that
                            # cannot prewarm cannot serve; keep the old one.
                            logging.exception(
                                "restore: prewarm of %s failed; not swapping",
                                loaded.export_dir,
                            )
                            return False
                    with self._lock:
                        self._loaded = loaded
                        self._predict_fn = predict_fn
                    return True
            if time.monotonic() - start > self._timeout:
                return False
            time.sleep(POLL_SECONDS)

    def _build_predict_fn(self, loaded: ExportedModel) -> Callable:
        if loaded.has_program:
            return loaded.predict
        if loaded.quant_regime != "none":
            # Model code rebuilds the f32 forward: under a regime that would
            # serve full precision where the operator asked for less.
            errors = (loaded.metadata.get("serve_quant") or {}).get("stablehlo_error")
            raise ValueError(
                f"Export {loaded.export_dir} has no serving program for "
                f"quant regime {loaded.quant_regime!r} "
                f"({(errors or {}).get(loaded.quant_regime)}); re-export it or "
                "serve with T2R_SERVE_QUANT=none.")
        if self._t2r_model is None:
            raise ValueError(
                f"Export {loaded.export_dir} has no program "
                f"({loaded.metadata.get('program_error')}); construct the "
                "predictor with t2r_model= to serve it from model code."
            )
        predict_fn, _ = build_model_code_serving_fn(
            self._t2r_model, loaded, device=self._device
        )
        return predict_fn

    def init_randomly(self, generator: Optional[torch.Generator] = None) -> None:
        """Serves random weights from model code: for tests and robot
        bring-up before any export exists."""
        if self._t2r_model is None:
            raise ValueError("init_randomly requires t2r_model.")
        predict_fn, export_generator = build_model_code_serving_fn(
            self._t2r_model, device=self._device, generator=generator
        )
        with self._lock:
            self._loaded = make_random_loaded(export_generator)
            self._predict_fn = predict_fn

    @property
    def loaded_model(self):
        """The loaded ExportedModel (None before restore); consumers that
        keep their loop on the card call its traced_predict."""
        with self._lock:
            return self._loaded

    # -- predict ----------------------------------------------------------------

    def _serving_callable(self, loaded, predict_fn) -> Callable:
        """predict()'s view (flatten + tiling) of one (loaded, predict_fn)
        pair: what a restore prewarm runs, the same as predict() will run
        once the pair is swapped in."""

        def serve(features: Mapping[str, Any]) -> Dict[str, Any]:
            flat = dict(flatten_spec_structure(features).items())
            if self._tile:
                flat = self._maybe_expand_dims(loaded.feature_spec, flat)
            return dict(predict_fn(flat))

        return serve

    def predict(self, features: Mapping[str, Any]) -> Dict[str, Any]:
        return self.predict_versioned(features)[0]

    def predict_versioned(self, features: Mapping[str, Any]):
        """(outputs, the version that computed them), the pair read at
        once: a swap landing mid-call cannot mislabel the outputs."""
        self.assert_is_loaded()
        with self._lock:
            loaded, predict_fn = self._loaded, self._predict_fn
        serve = self._serving_callable(loaded, predict_fn)
        return serve(features), version_of(loaded)

    def _maybe_expand_dims(
        self, spec: TensorSpecStruct, flat: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Aligns input ranks with the exported spec: a missing leading
        dim (the CEM action-population dim of predict-mode specs) is
        inserted, and a singleton population dim broadcast up to the
        spec's."""
        out = {}
        flat_spec = flatten_spec_structure(spec)
        for key, value in flat.items():
            value = np.asarray(value)
            leaf = flat_spec.get(key)
            if isinstance(leaf, ExtendedTensorSpec):
                want = len(leaf.shape) + 1  # + batch dim
                while value.ndim < want:
                    value = np.expand_dims(value, axis=1 if value.ndim >= 1 else 0)
                if value.ndim == want and leaf.shape and leaf.shape[0] is not None:
                    if value.shape[1] == 1 and leaf.shape[0] > 1:
                        value = np.repeat(value, leaf.shape[0], axis=1)
            out[key] = value
        return out

    # -- introspection ----------------------------------------------------------

    def get_feature_specification(self) -> TensorSpecStruct:
        self.assert_is_loaded()
        return self._loaded.feature_spec

    def get_label_specification(self) -> Optional[TensorSpecStruct]:
        self.assert_is_loaded()
        return self._loaded.label_spec

    @property
    def model_version(self) -> int:
        return version_of(self._loaded)

    @property
    def global_step(self) -> int:
        return -1 if self._loaded is None else int(self._loaded.global_step)

    @property
    def model_path(self) -> Optional[str]:
        return None if self._loaded is None else self._loaded.export_dir

    @property
    def quant_regime(self) -> str:
        """The serving regime of the loaded version ('none' before restore
        or when serving f32): what the server's snapshot reports."""
        loaded = self.loaded_model
        return getattr(loaded, "quant_regime", "none") if loaded else "none"

    @property
    def native_dot_layers(self) -> tuple:
        """The loaded version's natively contracted layers
        (ExportedModel.native_dot_layers); empty before restore."""
        return tuple(getattr(self.loaded_model, "native_dot_layers", ()) or ())

    @property
    def native_attention(self) -> tuple:
        """The loaded version's lowered attention modules."""
        return tuple(getattr(self.loaded_model, "native_attention", ()) or ())

    @property
    def calib_mode(self) -> Optional[str]:
        """The loaded regime's activation-calibration mode, or None."""
        return getattr(self.loaded_model, "calib_mode", None)

    @property
    def quant_reduce_audit(self) -> Optional[Dict[str, Any]]:
        """The loaded regime's reduce audit, or None."""
        return getattr(self.loaded_model, "quant_reduce_audit", None)

    @property
    def restore_thread_leaked(self) -> bool:
        """True when close() gave up waiting on a restore thread."""
        return self._restore_thread_leaked

    def close(self, join_timeout: float = 30.0) -> None:
        with self._lock:
            thread = self._restore_thread
        if thread is not None and thread.is_alive():
            thread.join(timeout=join_timeout)
            if thread.is_alive():
                # The restore's busy-wait may outlive us (its timeout can
                # be minutes): say so instead of abandoning it silently.
                self._restore_thread_leaked = True
                logging.warning(
                    "ExportedSavedModelPredictor.close(): async restore "
                    "thread still alive after %.0fs join; leaking it "
                    "(daemon, polling %s)", join_timeout, self._export_dir,
                )
