"""Console logging with ANSI colors (replaces the reference's termcolor cprint
usage [ref: train.py:47-48]) plus a std logging handle."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_ANSI = {
    "grey": "\033[90m",
    "red": "\033[91m",
    "green": "\033[92m",
    "yellow": "\033[93m",
    "blue": "\033[94m",
    "magenta": "\033[95m",
    "cyan": "\033[96m",
    "white": "\033[97m",
}
_RESET = "\033[0m"
_BOLD = "\033[1m"


def _want_color() -> bool:
    if os.environ.get("NO_COLOR"):
        return False
    return sys.stdout.isatty()


def cprint(msg, color: Optional[str] = None, on_color: Optional[str] = None, attrs=None):
    """termcolor.cprint-compatible signature (on_color ignored beyond bolding)."""
    text = str(msg)
    if _want_color() and (color in _ANSI or attrs):
        prefix = _ANSI.get(color or "", "")
        if attrs and "bold" in attrs:
            prefix += _BOLD
        text = f"{prefix}{text}{_RESET}"
    print(text, flush=True)


def get_logger(name: str = "speech_decoding_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger
