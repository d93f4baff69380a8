"""Checkpoints of the whole train state, with resume and a best-model copy.

Port of ``speech_decoding_tpu/training/checkpoint.py``: the same API and
semantics, in torch's format instead of orbax's. The reference only ever
``torch.save``s the encoder weights to a fixed file every epoch — no
optimizer state, no temperature, no resume path [ref: train.py:259].

One checkpoint is one ``torch.save`` file, ``epoch_<n>.pt``, holding
``step``, the encoder's ``state_dict`` (parameters and BatchNorm running
statistics), the CLIP temperature and the optimizer's ``state_dict`` (Adam,
or ``MultiSteps`` with its accumulated gradients), all as host copies. A
restore loads the file to the host and lets each ``load_state_dict`` place
its tensors: parameters, statistics and Adam's moments go to the state's
device, Adam's step counter stays on the host, where a non-capturable Adam
requires it (loading the file onto the card would put it there and fail
the next step). A file is written under a
temporary name and then renamed, so a save that is killed never leaves a
half checkpoint. Saves are synchronous: ``wait()`` returns at once.

Orbax directories written by the JAX package are not read. Their
parameters reach the port through ``models/params_bridge.py``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from speech_decoding_tpu_torch.training.state import TrainState
from speech_decoding_tpu_torch.utils.logging import cprint

_FILE = re.compile(r"^epoch_(\d+)\.pt$")


def _host(obj):
    """``obj`` with every tensor copied to the host (dicts, lists and tuples
    walked)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


class CheckpointManager:
    """The ``keep`` newest checkpoints (resume takes the newest) plus, when
    ``track_metric`` is set, one best-model checkpoint in the sibling
    ``<dir>-best/``, keyed on that metric of the epoch (e.g.
    "testTop10acc"; ``track_mode`` "max" or "min"; on a tie the newer epoch
    wins, as orbax keeps it). ``every_epochs`` sets the cadence of the
    rolling checkpoints; ``save(force=True)`` bypasses it (a preempted
    epoch). The best-model checkpoint is considered every epoch."""

    def __init__(self, directory: str, keep: int = 3, every_epochs: int = 1, track_metric: Optional[str] = None,
                 track_mode: str = "max"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(1, int(keep))
        self.every_epochs = max(1, int(every_epochs))
        self.track_metric = track_metric or None
        self.best_directory = None
        self._best_value: Optional[float] = None
        if self.track_metric:
            if track_mode not in ("max", "min"):
                raise ValueError(f"checkpoint.track_mode must be 'max' or 'min', got {track_mode!r}")
            self.track_mode = track_mode
            self.best_directory = self.directory.rstrip("/") + "-best"
            os.makedirs(self.best_directory, exist_ok=True)

    # -- files -----------------------------------------------------------------

    @staticmethod
    def _epochs(directory: str) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(directory)) if m)

    @staticmethod
    def _path(directory: str, epoch: int) -> str:
        return os.path.join(directory, f"epoch_{epoch}.pt")

    def _write(self, directory: str, epoch: int, payload: Dict) -> None:
        path = self._path(directory, epoch)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    @staticmethod
    def _payload(state: TrainState, metrics: Optional[Dict] = None) -> Dict:
        return _host({"step": int(state.step), "encoder": state.encoder.state_dict(),
                      "temp": state.clip.temp.detach(), "optimizer": state.optimizer.state_dict(),
                      "metrics": dict(metrics) if metrics else None})

    def _load(self, best: bool, epoch: Optional[int]) -> Tuple[Dict, int]:
        if best and self.best_directory is None:
            raise ValueError("best-model tracking is not configured (no track_metric)")
        if epoch is None:
            epoch = self.best_epoch() if best else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.best_directory if best else self.directory}")
        path = self._path(self.best_directory if best else self.directory, epoch)
        # weights_only: the payload holds tensors, numbers, strings and dicts only
        return torch.load(path, map_location="cpu", weights_only=True), epoch

    def _held_best(self) -> Optional[float]:
        """The metric of the held best-model checkpoint (read from its file
        once, when a manager opens a directory that has one)."""
        best = self.best_epoch()
        if self._best_value is None and best is not None:
            ck = torch.load(self._path(self.best_directory, best), map_location="cpu", weights_only=True)
            self._best_value = float(ck["metrics"][self.track_metric])
        return self._best_value

    # -- the JAX package's API ---------------------------------------------------

    def save(self, epoch: int, state: TrainState, extra: Optional[Dict] = None, force: bool = False) -> None:
        """``extra``: the epoch's metrics; feeds best-model tracking when
        ``track_metric`` is set. ``force`` bypasses the ``every_epochs``
        cadence (preemption-requested mid-epoch saves)."""
        payload = None
        if self.best_directory is not None and extra and self.track_metric in extra:
            value = float(extra[self.track_metric])
            held = self._held_best()
            if held is None or (value >= held if self.track_mode == "max" else value <= held):
                payload = self._payload(state, extra)
                self._write(self.best_directory, epoch, payload)
                self._best_value = value
                for old in self._epochs(self.best_directory):
                    if old != epoch:
                        os.remove(self._path(self.best_directory, old))
        if epoch % self.every_epochs and not force:
            return
        self._write(self.directory, epoch, payload or self._payload(state, extra))
        for old in self._epochs(self.directory)[: -self.keep]:
            os.remove(self._path(self.directory, old))

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs(self.directory)
        return epochs[-1] if epochs else None

    def best_epoch(self) -> Optional[int]:
        if self.best_directory is None:
            return None
        epochs = self._epochs(self.best_directory)
        return epochs[-1] if epochs else None

    def restore(self, state: TrainState, epoch: Optional[int] = None, best: bool = False) -> Tuple[TrainState, int]:
        """Load the whole state in place (step, parameters, running
        statistics, temperature, optimizer); returns (state, epoch).
        ``best=True`` restores the best-model checkpoint instead of the
        latest."""
        ck, epoch = self._load(best, epoch)
        self._load_model(state, ck)
        state.optimizer.load_state_dict(ck["optimizer"])
        cprint(f"Restored checkpoint @ epoch {epoch} from {self.directory}", "green")
        return state, epoch

    def restore_for_eval(self, state: TrainState, epoch: Optional[int] = None,
                         best: bool = False) -> Tuple[TrainState, int]:
        """Load parameters, running statistics, temperature and step only,
        ignoring the saved optimizer state: eval and serving never need it,
        and its shape depends on the training wiring (``MultiSteps`` for
        Brennan runs), so a MultiSteps checkpoint restores into an Adam
        state."""
        ck, epoch = self._load(best, epoch)
        self._load_model(state, ck)
        cprint(f"Restored checkpoint (eval: params/stats only) @ epoch {epoch} from {self.directory}", "green")
        return state, epoch

    @staticmethod
    def _load_model(state: TrainState, ck: Dict) -> None:
        state.encoder.load_state_dict(ck["encoder"], strict=True)
        with torch.no_grad():
            state.clip.temp.copy_(ck["temp"])
        state.step = int(ck["step"])
