"""1-Hz progress reporter thread.

Mirrors the reference feedback daemon (flowdenoising.py:292-295): percent =
100 * completed_units / (Z + Y + X), one count per output slice per pass.
Whole passes complete at once, so units advance per pass.
"""

from __future__ import annotations

import logging
import threading
import time


class ProgressReporter:
    def __init__(self, total_units: int, interval: float = 1.0):
        self.total = max(int(total_units), 1)
        self.done = 0
        self.interval = interval
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def advance(self, units: int) -> None:
        with self._lock:
            self.done += units

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            with self._lock:
                pct = 100.0 * self.done / self.total
            logging.info(f"{pct:.1f} %")

    def __enter__(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        return False
