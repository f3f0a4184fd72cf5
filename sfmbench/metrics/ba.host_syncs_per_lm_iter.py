"""Host syncs of the bundle adjustments per Levenberg-Marquardt iteration:
the syncs inside the program's ba.* spans (the problem's upload, the stop
test of each LM and CG iteration, the pulls of the results), counter
ba_host_syncs, over ba_iters + ba_selfcal_iters. None where the program
has no such counter."""

UNIT = "count"
LAYER = "bundle adjustment"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_counter"
DRIVERS = ("chained", "pipeline")


def read(run):
    iters = run.counter("ba_iters") + run.counter("ba_selfcal_iters")
    if not iters or not any("ba_host_syncs" in m.counters for m in run.maps):
        return None
    return run.counter("ba_host_syncs") / iters
