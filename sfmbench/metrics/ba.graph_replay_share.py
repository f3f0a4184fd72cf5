"""Share of the bundle adjustments' stretches of device work that ran as
a replayed CUDA graph: ba_graph_replays over ba_graph_captures +
ba_graph_replays (a solve captures each stretch on its first run and
replays it on every later one). None where the program has no such
counter. With a fixed number of stretches per solve the share follows the
LM and CG iterations per solve: a change that makes the solves converge in
fewer iterations lowers it while it saves time, so read it beside
`ba.ms_per_lm_iter`, not alone; the captures, what a graph cache across
solves would remove, are its complement."""

UNIT = "share"
LAYER = "bundle adjustment"
MOVES = "frames_per_s"
BETTER = "higher"
SOURCE = "program_counter"
DRIVERS = ("chained", "pipeline")


def read(run):
    captures = run.counter("ba_graph_captures")
    replays = run.counter("ba_graph_replays")
    if not captures + replays:
        return None
    return replays / (captures + replays)
