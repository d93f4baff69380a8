"""The run's clock: its zero is when this module is first imported, which
``run.py`` does before anything else."""

import sys
import time

T0 = time.perf_counter()


def log(phase: str) -> None:
    """A phase's time since the run began, on standard error."""
    print(f"port_bench: {phase} at {time.perf_counter() - T0:.3f} s", file=sys.stderr, flush=True)
