"""Wall milliseconds of registration per frame offered: the harness's
`register` spans around process_initial / process_chain_k / process (each
ended by a synchronize), less the window solves that ran inside them
(their ba_solve_s)."""

UNIT = "ms"
LAYER = "mapper"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "host_clock"
DRIVERS = ("chained",)


def read(run):
    if not run.offered:
        return None
    return 1000.0 * sum(m.stats["register_s"] for m in run.maps) / run.offered
