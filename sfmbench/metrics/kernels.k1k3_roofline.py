"""Share of their roofline that the hand kernels K1-K3 reach over the
traced window: the sum over every launch of its bound (operations and
bytes from its shapes, sfmbench/reference/roofline.py, recorded by
wrapping the three ops/cuda entry points) over the profiler's device time
of the kernels by name."""

UNIT = "%"
LAYER = "hand kernels"
MOVES = "frames_per_s"
BETTER = "higher"
SOURCE = "device_trace"
DRIVERS = ("chained", "pipeline")


def read(run):
    t = run.trace
    if not t or t["hand_kernel_s"] <= 0 or not t["hand_launches"]:
        return None
    return 100.0 * t["hand_bound_s"] / t["hand_kernel_s"]
