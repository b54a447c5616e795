"""Named accumulating phase timers + periodic reporter (twin of
`pmdfc_tpu/utils/timers.py`).

Reference tracing/profiling: the server wraps data-path phases with
`clock_gettime` deltas into named accumulators under `-DTIME_CHECK`
(`server/rdma_svr.cpp:64-76,345-352`), dumped every 10 s by the
`rdpma_indicator` thread (:145-150); the client does the same in-kernel with
`fperf_start/end/save` (`client/timeperf.h:20-90`).

Here: `Timers` is a thread-safe registry of named accumulators; `phase()` is
the context-manager form of fperf_start/end; `Reporter` is the indicator
thread. CUDA work is asynchronous, so a phase that ends in a host copy of a
result measures the device work it waited for; one that only launches
measures the launch.
"""

from __future__ import annotations

import contextlib
import threading
import time


class Timers:
    def __init__(self):
        self._lock = threading.Lock()  # guarded-by: _acc
        self._acc: dict[str, list] = {}  # name -> [total_s, count]

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            acc = self._acc.setdefault(name, [0.0, 0])
            acc[0] += seconds
            acc[1] += 1

    def averages_us(self) -> dict[str, float]:
        """Per-phase average microseconds (the `rdpma_print_stats` table,
        `server/rdma_svr.cpp:119-135`)."""
        with self._lock:
            return {
                k: round(v[0] / v[1] * 1e6, 2)
                for k, v in self._acc.items() if v[1]
            }

    def totals_s(self) -> dict[str, float]:
        with self._lock:
            return {k: round(v[0], 4) for k, v in self._acc.items()}

    def counts(self) -> dict[str, int]:
        with self._lock:
            return {k: v[1] for k, v in self._acc.items()}

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()

    def report(self) -> str:
        avg = self.averages_us()
        cnt = self.counts()
        return ", ".join(f"{k}={avg[k]}us(x{cnt[k]})" for k in sorted(avg))


class Reporter:
    """Periodic stats printer (the `rdpma_indicator` 10 s thread,
    `server/rdma_svr.cpp:145-150`)."""

    def __init__(self, interval_s: float = 10.0, sinks=()):
        """`sinks` are zero-arg callables returning a printable line."""
        self.interval_s = interval_s
        self.sinks = list(sinks)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Reporter":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pmdfc-indicator")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            for sink in self.sinks:
                try:
                    line = sink()
                    if line:
                        print(f"[indicator] {line}", flush=True)
                except Exception as e:  # one bad sink must not kill the loop
                    print(f"[indicator] sink error: {e}", flush=True)
