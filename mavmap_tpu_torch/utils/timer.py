"""Timers, spans and profiling (counterpart of reference src/util/timer.{h,cc}).

Port of mavmap_tpu/utils/timer.py: the reference's Timer, accumulating
stage timers, and a device trace context, here a torch.profiler trace
(CPU, and CUDA where a card is present) written for TensorBoard in place
of the JAX package's jax.profiler trace; a count of a call's host syncs
with a CUDA device; and the program's spans and host-sync counter.

Spans (`span`) mark the program's own boundaries: registration's prepare,
dispatch, pose LM, wait and commit, the bundle adjustments' solves and the
landing of their results, the loop retrieval and pipeline stages, the
CLI's inputs and outputs and the feature dumps' reads. A span with a
counter adds its inclusive seconds (time.perf_counter) to a counter of its
owner, a SequentialMapper's `counters`, or to a `totals` dict (the
pipeline's stage timings, the CLI's). A span opened without an owner, in
ba/core.py or sfm/kernels.py, takes the mapper of the innermost open span
that names one, through a context variable; outside every such span it
does nothing. `owner_counters(totals)` is that mapper's counters, or
`totals` outside every mapper's span: a step that runs both inside and
outside a mapper's span (a feature read) counts into it; `count(name)`
adds to one of that mapper's event counters.
A `totals` dict may be shared by threads (the CLI's feature extraction
adds to its timings from three workers): a span given `totals` adds to it
under a lock, and `add_total` adds a count the same way, so no addition
is lost; that holds too where `totals` is a mapper's counters, handed in
by `owner_counters`. A span that counts into its mapper's counters
without `totals` takes no lock: those belong to the one thread that maps.
`sync(n)` counts host syncs, the points where the program blocks on the
card, into that mapper's counters["host_syncs"] (and "ba_host_syncs"
inside a span named "ba.*"). While `recording()` is open, every span also
appends (name, start_ns, end_ns, depth, parent, syncs) on time.time_ns(),
the clock of torch.profiler's event timestamps, to the list it yields.
Spans leave no mark in the profiler's trace: a user annotation there would
count as device activity.
"""

import contextlib
import contextvars
import os
import threading
import time
import warnings
from collections import defaultdict

# The innermost open span of this thread (or task) that set it: (the owning
# mapper's counters or None, inside a span named "ba.*", the open record or
# None).
_STATE = contextvars.ContextVar("mavmap_tpu_torch_span", default=(None, False, None))
# The list of the open recording(), or None.
_RECORDS = contextvars.ContextVar("mavmap_tpu_torch_records", default=None)
# Serialises additions to `totals` dicts, which several threads may share.
_TOTALS_LOCK = threading.Lock()


class _Record:
    """An open span while recording: its name, start, depth, parent's
    name and host syncs so far."""

    __slots__ = ("name", "start_ns", "depth", "parent", "syncs")

    def __init__(self, name, parent):
        self.name = name
        self.start_ns = time.time_ns()
        self.depth = 0 if parent is None else parent.depth + 1
        self.parent = None if parent is None else parent.name
        self.syncs = 0


class _Span:
    __slots__ = ("name", "counter", "owner", "totals", "t0", "token", "sink", "rec", "out")

    def __init__(self, name, counter, owner, totals):
        self.name = name
        self.counter = counter
        self.owner = owner
        self.totals = totals

    def __enter__(self):
        counters, in_ba, parent = _STATE.get()
        if self.owner is not None:
            counters = self.owner.counters
        self.sink = self.totals if self.totals is not None else counters
        self.token = self.rec = None
        if counters is None and self.totals is None:
            return self  # outside every mapper's span: nothing to count or record
        self.out = _RECORDS.get()
        if self.out is not None:
            self.rec = _Record(self.name, parent)
        if self.owner is not None or self.rec is not None:
            self.token = _STATE.set((counters, in_ba or self.name.startswith("ba."),
                                     self.rec or parent))
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sink is None:
            return False
        if self.counter is not None:
            dt = time.perf_counter() - self.t0
            if self.totals is None:
                self.sink[self.counter] = self.sink.get(self.counter, 0.0) + dt
            else:
                add_total(self.totals, self.counter, dt)
        rec = self.rec
        if rec is not None:
            self.out.append((rec.name, rec.start_ns, time.time_ns(), rec.depth, rec.parent,
                             rec.syncs))
        if self.token is not None:
            _STATE.reset(self.token)
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name, counter=None, owner=None, totals=None):
    """Context manager around one of the program's steps. counter: the key
    that takes the span's inclusive seconds, in `totals` if given, else in
    the owning mapper's `counters`; owner: that mapper (default: the owner
    of the innermost open span). A span with neither counter nor owner costs
    one check while nothing records."""
    if counter is None and owner is None and _RECORDS.get() is None:
        return _NO_SPAN
    return _Span(name, counter, owner, totals)


def add_total(totals, name, n=1):
    """Add `n` to `totals[name]`, a dict that several threads may share;
    nothing where `totals` is None."""
    if totals is None:
        return
    with _TOTALS_LOCK:
        totals[name] = totals.get(name, 0) + n


def owner_counters(default=None):
    """The counters of the mapper that owns the innermost open span, or
    `default` outside every mapper's span."""
    counters = _STATE.get()[0]
    return default if counters is None else counters


def count(name, n=1):
    """Add `n` to the counter `name` of the mapper that owns the innermost
    open span; nothing outside every mapper's span."""
    counters = _STATE.get()[0]
    if counters is not None:
        counters[name] = counters.get(name, 0) + n


def sync(n=1):
    """Count `n` host syncs (a pull or a blocking upload of a tensor with
    elements, a bool / int / float of a device scalar, an event wait, an
    implicit sync such as a boolean-mask index) into the owning mapper's
    counters, and into the innermost recorded span. The same sites count
    on the CPU, where they do not block."""
    counters, in_ba, rec = _STATE.get()
    if counters is None or not n:
        return
    counters["host_syncs"] = counters.get("host_syncs", 0) + n
    if in_ba:
        counters["ba_host_syncs"] = counters.get("ba_host_syncs", 0) + n
    if rec is not None:
        rec.syncs += n


@contextlib.contextmanager
def recording():
    """Record every span closed while the block runs; yields the list of
    (name, start_ns, end_ns, depth, parent, syncs), in closing order.
    start_ns / end_ns are time.time_ns(); depth counts the recorded spans
    open around it (0 outermost) and parent is the name of the innermost
    of them (None at depth 0)."""
    if _RECORDS.get() is not None:
        raise RuntimeError("recording() is already open")
    out = []
    token = _RECORDS.set(out)
    try:
        yield out
    finally:
        _RECORDS.reset(token)


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
