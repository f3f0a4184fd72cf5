"""Host syncs per frame offered: every point where the program blocks on
the card (a pull, a blocking upload, a bool / float of a device scalar, an
event wait, an implicit sync), counter host_syncs. None where the program
has no such counter."""

UNIT = "count"
LAYER = "device"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_counter"
DRIVERS = ("chained", "pipeline")


def read(run):
    if not run.offered or not any("host_syncs" in m.counters for m in run.maps):
        return None
    return run.counter("host_syncs") / run.offered
