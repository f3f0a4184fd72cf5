"""Timers + profiling (counterpart of reference src/util/timer.{h,cc}).

Port of mavmap_tpu/utils/timer.py: the reference's Timer, accumulating
stage timers, and a device trace context, here a torch.profiler trace
(CPU, and CUDA where a card is present) written for TensorBoard in place
of the JAX package's jax.profiler trace; and a count of a call's host
syncs with a CUDA device.
"""

import contextlib
import os
import time
import warnings
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


def count_syncs(fn, sites=None):
    """(host syncs, fn()) with CUDA's sync debug mode warning on every
    synchronizing call inside fn (device->host reads, blocking copies,
    stream waits); `sites`, a list, gets the file:line of each."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    if sites is not None:
        sites.extend(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs)
    return len(syncs), out
