"""Host milliseconds per frame offered in detection: the program's
`features.detect` spans (one per frame, from the upload to the returned
host arrays; counter detect_s, and one to detect_frames), summed over the
extraction's threads, from the mappers' counters and the CLI's own
timings.

These are contended thread-seconds: the CLI extracts on three threads
that share one interpreter lock, so a span also counts the time other
threads hold the lock (PNG inflate, npz writes), and the sum over threads
can exceed the stage's wall time. Work taken out of decoding can make
this number rise. Read it only beside `features.extract_ms_per_frame`,
the stage's wall time."""

UNIT = "ms"
LAYER = "feature extraction"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("photo_cli",)


def _total(run, name):
    return run.counter(name) + sum(m.timings.get(name, 0) for m in run.maps)


def read(run):
    if not run.offered or not _total(run, "detect_frames"):
        return None
    return 1000.0 * _total(run, "detect_s") / run.offered
