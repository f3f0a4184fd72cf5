"""Host milliseconds per frame offered in decoding the frames' image
files: the program's `features.decode` spans (reading and converting one
PNG; counter image_decode_s, and one to image_decodes), summed over the
extraction's threads, from the mappers' counters and the CLI's own
timings.

These are contended thread-seconds: the CLI extracts on three threads
that share one interpreter lock, so a span also counts the time other
threads hold the lock (detection's dispatch, npz writes). Read it only
beside `features.extract_ms_per_frame`, the stage's wall time."""

UNIT = "ms"
LAYER = "feature extraction"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("photo_cli",)


def _total(run, name):
    return run.counter(name) + sum(m.timings.get(name, 0) for m in run.maps)


def read(run):
    if not run.offered or not _total(run, "image_decodes"):
        return None
    return 1000.0 * _total(run, "image_decode_s") / run.offered
