"""Host milliseconds per frame offered that registration spends before it
waits on the card: the program's register.prepare spans (device features,
the anchor's track state, packing and uploads) and register.dispatch
spans (the device step enqueued, the pose LM's included), counters
reg_prepare_s and reg_dispatch_s. None where the program has no such
spans."""

UNIT = "ms"
LAYER = "mapper"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("chained", "pipeline")
COUNTERS = ("reg_prepare_s", "reg_dispatch_s")


def read(run):
    if not run.offered or not any(c in m.counters for m in run.maps for c in COUNTERS):
        return None
    return 1000.0 * sum(run.counter(c) for c in COUNTERS) / run.offered
