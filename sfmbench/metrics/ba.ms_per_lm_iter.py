"""Host milliseconds per Levenberg-Marquardt iteration of every bundle
adjustment of the window (window, initial, global and self-calibration
solves): (ba_solve_s + ba_selfcal_s) over (ba_iters + ba_selfcal_iters)."""

UNIT = "ms"
LAYER = "bundle adjustment"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("chained", "pipeline")


def read(run):
    iters = run.counter("ba_iters") + run.counter("ba_selfcal_iters")
    if not iters:
        return None
    return 1000.0 * (run.counter("ba_solve_s") + run.counter("ba_selfcal_s")) / iters
