"""Wall-clock durations for progress lines (a copy of
``repro.exec.timing``).

:class:`Stopwatch` is where the training loop reads the clock: a duration
for stdout and for the straggler watch, never a value written into a
checkpoint or any other artifact.
"""
from __future__ import annotations

import time


class Stopwatch:
    """Monotonic duration meter: ``Stopwatch().seconds`` since creation."""

    __slots__ = ("_t0",)

    def __init__(self) -> None:
        self._t0 = time.perf_counter()

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self._t0

    def round(self, ndigits: int = 2) -> float:
        return round(self.seconds, ndigits)
