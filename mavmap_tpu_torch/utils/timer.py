"""Timers + profiling (counterpart of reference src/util/timer.{h,cc}).

Port of mavmap_tpu/utils/timer.py: the reference's Timer, accumulating
stage timers, and a device trace context, here a torch.profiler trace
(CPU, and CUDA where a card is present) written for TensorBoard in place
of the JAX package's jax.profiler trace.
"""

import contextlib
import time
from collections import defaultdict


class Timer:
    """Wall-clock timer with the reference's start/restart/elapsed/print API."""

    def __init__(self):
        self._start = None
        self._elapsed = 0.0

    def start(self):
        self._start = time.perf_counter()

    def restart(self):
        self._elapsed = 0.0
        self.start()

    def pause(self):
        if self._start is not None:
            self._elapsed += time.perf_counter() - self._start
            self._start = None

    def elapsed_time(self):
        run = 0.0 if self._start is None else time.perf_counter() - self._start
        return self._elapsed + run

    def print(self, label="Elapsed time"):
        t = self.elapsed_time()
        mins, secs = divmod(t, 60.0)
        print(f"{label}: {int(mins)} [minutes] {secs:.3f} [seconds]")


class StageTimers:
    """Accumulating per-stage timers for pipeline observability."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t:.3f}s total, {c} calls, {1000*t/c:.1f} ms/call")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir):
    """torch.profiler trace of the block (CPU activity, and the card's
    kernels where CUDA is available), written to `log_dir` for TensorBoard;
    yields the profiler (key_averages() for sums by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as p:
        yield p
