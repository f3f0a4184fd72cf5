"""Host milliseconds per frame offered in the track store's commits: the
program's register.commit spans (host gates, poses, track continuations,
new points) and ba.apply spans (a solve's results pulled and written to
the store), counters reg_commit_s and ba_apply_s. None where the program
has no such spans."""

UNIT = "ms"
LAYER = "track store"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("chained", "pipeline")
COUNTERS = ("reg_commit_s", "ba_apply_s")


def read(run):
    if not run.offered or not any(c in m.counters for m in run.maps for c in COUNTERS):
        return None
    return 1000.0 * sum(run.counter(c) for c in COUNTERS) / run.offered
