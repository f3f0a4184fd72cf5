"""Host milliseconds per frame offered in writing the CLI's output files:
the program's `cli.outputs` span (imagedataout.txt, the point clouds, the
VRML models), from the CLI's own timings."""

UNIT = "ms"
LAYER = "CLI"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("cli",)


def read(run):
    if not run.offered or not any("cli.outputs" in m.timings for m in run.maps):
        return None
    return 1000.0 * sum(m.timings.get("cli.outputs", 0.0) for m in run.maps) / run.offered
