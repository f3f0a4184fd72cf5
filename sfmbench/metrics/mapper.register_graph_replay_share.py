"""Share of registration's chain frame steps that ran as a replayed CUDA
graph: reg_graph_replays over reg_graph_captures + reg_graph_replays +
reg_eager_steps (a chain frame step on the card is captured on the first
step of its key in the process, replayed on every later one, or run
eagerly). None where the program has none of those counters. The
captures happen in the warm-up map, so a window's share is its eager
steps' complement."""

UNIT = "share"
LAYER = "mapper"
MOVES = "frames_per_s"
BETTER = "higher"
SOURCE = "program_counter"
DRIVERS = ("chained", "pipeline")


def read(run):
    replays = run.counter("reg_graph_replays")
    steps = run.counter("reg_graph_captures") + replays + run.counter("reg_eager_steps")
    if not steps:
        return None
    return replays / steps
