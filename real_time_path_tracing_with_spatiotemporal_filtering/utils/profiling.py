"""Profiling and timing harness.

The reference has no profiling beyond debug-utils object names
(SURVEY.md section 5.1); the equivalents here are a wall-clock pass timer
that waits for the device and a ``jax.profiler`` trace context.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


def sync(tree) -> None:
    """Wait until every device array of a pytree is computed."""
    jax.block_until_ready(tree)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2, pipelined: bool = True):
    """Wall-clock an on-device function. Returns ms per call.

    ``pipelined``: sync only once at the end (throughput; dispatches overlap
    device work). Otherwise sync every call (latency, includes host round
    trip).
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
        if not pipelined:
            sync(out)
    if pipelined:
        sync(out)
    return (time.perf_counter() - t0) / iters * 1000.0


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context -- view with XProf/TensorBoard or read
    back with jax.profiler.ProfileData."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class FrameTimer:
    """Rolling per-frame FPS/ms counter for interactive loops (the
    reference prints a line per frame, main.cpp:1112 -- this is the
    metrics-minded version)."""

    def __init__(self, window: int = 30):
        self.window = window
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def ms_per_frame(self) -> float:
        if not self._times:
            return float("nan")
        return sum(self._times) / len(self._times) * 1000.0

    @property
    def fps(self) -> float:
        ms = self.ms_per_frame
        return 1000.0 / ms if ms == ms and ms > 0 else float("nan")
