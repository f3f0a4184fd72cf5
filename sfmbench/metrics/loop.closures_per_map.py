"""Loop and sweep closures committed per map (counters loop_closures and
sweep_closures): the correspondences that take the survey's drift out."""

UNIT = "count"
LAYER = "loop retrieval"
MOVES = "ate_m"
BETTER = "higher"
SOURCE = "program_counter"
DRIVERS = ("pipeline",)


def read(run):
    if not run.maps:
        return None
    return (run.counter("loop_closures") + run.counter("sweep_closures")) / len(run.maps)
