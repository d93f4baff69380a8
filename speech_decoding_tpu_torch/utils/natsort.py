"""Natural (human) sort for file ordering.

Copy of ``speech_decoding_tpu/utils/natsort.py``, which replaces the natsort
dependency of the reference's file ordering [ref: dataclass/brennan2018.py:155,235,
dataclass/gwilliams2022.py:315-320].
"""

from __future__ import annotations

import re
from typing import Iterable, List

_NUM_RE = re.compile(r"(\d+)")


def natsort_key(s: str):
    return tuple(int(p) if p.isdigit() else p for p in _NUM_RE.split(s))


def natsorted(items: Iterable[str]) -> List[str]:
    return sorted(items, key=natsort_key)
