"""Host milliseconds per frame offered in reading mavmap's feature dumps:
the program's `features.read` spans (counter feature_read_s, one per dump
pair read, feature_reads), in the mappers' counters and, for reads outside
every mapper's span, the CLI's own totals."""

UNIT = "ms"
LAYER = "feature I/O"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("cli",)


def _total(run, name):
    return run.counter(name) + sum(m.timings.get(name, 0) for m in run.maps)


def read(run):
    if not run.offered or not _total(run, "feature_reads"):
        return None
    return 1000.0 * _total(run, "feature_read_s") / run.offered
