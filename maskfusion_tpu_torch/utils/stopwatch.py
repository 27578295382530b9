"""Per-stage wall-time telemetry.

Equivalent of the reference Stopwatch singleton (Core/Utils/Stopwatch.h:64-170):
named TICK/TOCK sections aggregated per frame, optionally UDP-broadcast in the
same serialised format cadence (sendAll every ~10 s to 127.0.0.1:45454) so the
ElasticFusion external viewer keeps working.  Also exposes the 30 FPS frameskip
governor's decision input (MainController.cpp:487-489).

Copy of ``maskfusion_tpu/utils/stopwatch.py`` for the PyTorch port.  Scopes
read the host's wall clock, so on a card they time the host's dispatch of
the work, not the device's execution of it (no scope synchronises).
"""

from __future__ import annotations

import contextlib
import socket
import struct
import time
from collections import defaultdict
from typing import Dict


class Stopwatch:
    SEND_INTERVAL_S = 10.0
    PORT = 45454

    def __init__(self, enable_udp: bool = False):
        self.timings_ms: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last_ms: Dict[str, float] = {}
        self.enable_udp = enable_udp
        self._last_send = time.monotonic()
        self._sock = None

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1000.0)

    def record(self, name: str, ms: float):
        self.timings_ms[name] += ms
        self.counts[name] += 1
        self.last_ms[name] = ms
        if self.enable_udp:
            self._maybe_send()

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.timings_ms[name] / c if c else 0.0

    def summary(self) -> Dict[str, float]:
        return {k: self.mean_ms(k) for k in self.timings_ms}

    def should_skip_frames(self, budget_ms: float = 33.33) -> int:
        """Real-time governor: frames to skip when the last 'Run' section
        exceeded the budget (MainController.cpp:487-489)."""
        run = self.last_ms.get("Run", 0.0)
        return int(run / budget_ms) if run > budget_ms else 0

    # --- UDP export in the reference's wire format: int32 count, then per
    #     section a null-terminated name + float64 ms ---
    def _maybe_send(self):
        now = time.monotonic()
        if now - self._last_send < self.SEND_INTERVAL_S:
            return
        self._last_send = now
        try:
            if self._sock is None:
                self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            payload = struct.pack("<i", len(self.last_ms))
            for k, v in self.last_ms.items():
                payload += k.encode() + b"\0" + struct.pack("<d", v)
            self._sock.sendto(payload, ("127.0.0.1", self.PORT))
        except OSError:
            pass
