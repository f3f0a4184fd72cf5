"""Share of the traced window in which no operation ran on the card:
1 - (union of the device activity intervals) / (window), from the
profiler's trace."""

UNIT = "%"
LAYER = "device"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "device_trace"
DRIVERS = ("chained", "pipeline")


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
