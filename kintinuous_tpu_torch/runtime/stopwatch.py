"""Named-span timing telemetry (port of
kintinuous_tpu/runtime/stopwatch.py).

Spans (tick/tock or `with sw.span(name)`), per-thread heartbeats
(`pulse`), gauges such as a backend stage's lag, aggregate stats, and a
UDP sink: at most every 10 ms one JSON datagram {"sig", "timings"} to
127.0.0.1:<port>, inspectable with nc and jq.

The engine owns its Stopwatch and hands it to its workers. A
process-wide instance, as in the JAX package, is `Stopwatch.get()`; the
engine does not use it (the JAX engine does).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import defaultdict
from typing import Dict, Optional


class Stopwatch:
    _instance: Optional["Stopwatch"] = None
    _lock = threading.Lock()

    def __init__(self, port: int = 45454, send_interval_s: float = 0.01):
        self.port = port
        self.send_interval_s = send_interval_s
        self.signature = (os.getpid() << 16) | (int(time.time()) & 0xFFFF)
        self._starts: Dict[str, float] = {}
        self._timings: Dict[str, float] = {}
        self._counts: Dict[str, int] = defaultdict(int)
        self._totals: Dict[str, float] = defaultdict(float)
        self._mutex = threading.Lock()
        self._last_send = 0.0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.enabled = True

    @classmethod
    def get(cls) -> "Stopwatch":
        """The process-wide instance, made at the first call."""
        with cls._lock:
            if cls._instance is None:
                cls._instance = Stopwatch()
            return cls._instance

    def tick(self, name: str):
        self._starts[f"{threading.get_ident()}:{name}"] = time.perf_counter()

    def tock(self, name: str):
        t0 = self._starts.pop(f"{threading.get_ident()}:{name}", None)
        if t0 is None:
            return
        ms = (time.perf_counter() - t0) * 1e3
        with self._mutex:
            self._timings[name] = ms
            self._counts[name] += 1
            self._totals[name] += ms
        self.send_all()

    def span(self, name: str):
        sw = self

        class _Span:
            def __enter__(self):
                sw.tick(name)

            def __exit__(self, *exc):
                sw.tock(name)

        return _Span()

    def pulse(self, name: str):
        """Thread heartbeat."""
        with self._mutex:
            self._timings[f"pulse.{name}"] = 0.0
        self.send_all()

    def gauge(self, name: str, value_ms: float):
        """Publish an instantaneous value, e.g. a backend stage's lag
        behind the frame that produced its input."""
        with self._mutex:
            self._timings[name] = float(value_ms)
            self._counts[name] += 1
            self._totals[name] += float(value_ms)
        self.send_all()

    def max_gauge(self, prefix: str = "lag.") -> float:
        """Max current value over the gauges with the prefix."""
        with self._mutex:
            vals = [v for k, v in self._timings.items() if k.startswith(prefix)]
        return max(vals) if vals else 0.0

    def send_all(self):
        if not self.enabled:
            return
        now = time.monotonic()
        if now - self._last_send < self.send_interval_s:
            return
        self._last_send = now
        with self._mutex:
            payload = {"sig": self.signature, "timings": dict(self._timings)}
        try:
            self._sock.sendto(json.dumps(payload).encode(), ("127.0.0.1", self.port))
        except OSError:  # nobody listening, or the datagram too large: telemetry is best effort
            pass

    def stats(self) -> Dict[str, Dict[str, float]]:
        with self._mutex:
            return {
                name: {
                    "last_ms": self._timings.get(name, 0.0),
                    "mean_ms": self._totals[name] / max(1, self._counts[name]),
                    "count": self._counts[name],
                }
                for name in self._totals
            }

    def reset(self):
        with self._mutex:
            self._starts.clear()
            self._timings.clear()
            self._counts.clear()
            self._totals.clear()

    def close(self):
        self._sock.close()
