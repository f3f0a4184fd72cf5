"""Host milliseconds per frame offered that registration waits for the
card: the program's register.wait spans (the event wait behind a chain's
copies, the pulls of a step's outputs), counter reg_wait_s. None where the
program has no such span."""

UNIT = "ms"
LAYER = "mapper"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("chained", "pipeline")


def read(run):
    if not run.offered or not any("reg_wait_s" in m.counters for m in run.maps):
        return None
    return 1000.0 * run.counter("reg_wait_s") / run.offered
