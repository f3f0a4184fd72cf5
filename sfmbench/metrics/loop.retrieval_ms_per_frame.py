"""Host milliseconds per frame offered in loop retrieval: the vocabulary
tree's queries and the pair pre-gates, periodic and in the closure sweeps
(counters detect_query_s, detect_pregate_s, sweep_retrieval_s,
sweep_pregate_s)."""

UNIT = "ms"
LAYER = "loop retrieval"
MOVES = "frames_per_s"
BETTER = "lower"
SOURCE = "program_span"
DRIVERS = ("pipeline",)
COUNTERS = ("detect_query_s", "detect_pregate_s", "sweep_retrieval_s", "sweep_pregate_s")


def read(run):
    if not any(c in m.counters for m in run.maps for c in COUNTERS):
        return None
    return 1000.0 * sum(run.counter(c) for c in COUNTERS) / run.offered
