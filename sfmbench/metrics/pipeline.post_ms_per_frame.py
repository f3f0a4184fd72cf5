"""Host milliseconds per frame offered in run_pipeline's post-pass: every
stage timing but the sequential loop (back-fill, global BA, merge, closure
sweeps, control points, filter), from `PipelineResult.timings`."""

UNIT = "ms"
LAYER = "pipeline"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("pipeline",)


def read(run):
    post = sum(v for m in run.maps for k, v in m.timings.items() if k != "sequential_loop")
    return 1000.0 * post / run.offered if run.offered else None
