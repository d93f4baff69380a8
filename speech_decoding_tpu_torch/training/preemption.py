"""Preemption-safe training: cooperative SIGTERM handling + fault injection.

Copy of ``speech_decoding_tpu/training/preemption.py`` (framework-free);
the port's ``Trainer`` polls it the same way.

Spot and preemptible machines receive SIGTERM
shortly before shutdown. ``PreemptionGuard`` converts that into a flag the
``Trainer`` polls between optimizer steps; on request the current train
state is checkpointed immediately (mid-epoch, full state incl. optimizer and
step counter) and the epoch loop exits cleanly, so ``checkpoint.resume``
loses at most the in-flight step. The reference has no resume path at all —
it only ever overwrites ``model_last.pt`` [ref: train.py:259].

Semantics of a mid-epoch save: the checkpoint is written under the CURRENT
epoch index, so resume starts at the next epoch. An "epoch" here is a fixed
number of sampled updates, not a pass over the data
[ref: get_dataloaders.py:57-62], so dropping the tail of a preempted epoch is
equivalent to one slightly short epoch; the applied optimizer steps are never
re-run (``state.step`` round-trips through the checkpoint).

Fault injection: the reference has no failure-injection machinery (SURVEY
§5); ``inject_after_steps=N`` delivers a real ``SIGTERM`` to this process
after N train DISPATCHES (one dispatch = ``tpu.scan_steps`` optimizer steps
in scan mode), driving the whole signal -> flag -> mid-epoch save -> clean
exit -> resume chain deterministically in tests and drills
(``tpu.preempt_after_steps`` on the CLI).

Multi-host: every host installs the guard, but a lone flagged host must not
enter a collective checkpoint save alone. The Trainer polls local flags every
step and, across processes, agrees with a tiny all-reduce at a fixed step
cadence (``tpu.preempt_sync_every``) so all processes decide to save at the
same step.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional, Tuple

from speech_decoding_tpu_torch.utils.logging import cprint


class PreemptionGuard:
    """Installs signal handlers that set a flag instead of killing the
    process. Use as a context manager (restores previous handlers) or via
    ``install()`` / ``uninstall()``.

    Signal handlers can only be installed from the main thread; elsewhere
    the guard degrades to injection/manual ``request()`` mode with a warning
    (training still works, external SIGTERM just kills as before).
    """

    def __init__(
        self,
        signals: Tuple[int, ...] = (signal.SIGTERM,),
        inject_after_steps: Optional[int] = None,
    ):
        self._requested = threading.Event()
        self._signals = tuple(signals)
        self._old = {}
        self._installed = False
        self.inject_after_steps = (
            int(inject_after_steps) if inject_after_steps else None
        )
        self._steps = 0

    def install(self) -> "PreemptionGuard":
        try:
            for s in self._signals:
                self._old[s] = signal.signal(s, self._handler)
            self._installed = True
        except ValueError:  # not the main thread
            cprint(
                "PreemptionGuard: not in main thread — signal handlers not "
                "installed (flag/injection mode only)",
                "yellow",
            )
        return self

    def uninstall(self) -> None:
        if self._installed:
            for s, h in self._old.items():
                signal.signal(s, h)
            self._old.clear()
            self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _handler(self, signum, frame) -> None:
        # signal-safe: just set the flag; the Trainer acts between steps
        self._requested.set()

    def request(self) -> None:
        """Flag a preemption programmatically (tests / external watchers)."""
        self._requested.set()

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    def step_tick(self) -> None:
        """Count one train dispatch; drives ``inject_after_steps`` fault
        injection through the REAL signal path (os.kill SIGTERM)."""
        self._steps += 1
        if (
            self.inject_after_steps is not None
            and self._steps == self.inject_after_steps
        ):
            if self._installed:
                os.kill(os.getpid(), signal.SIGTERM)
            else:  # handler couldn't install: set the flag directly
                self._requested.set()
