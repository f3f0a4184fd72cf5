"""The reader of the bundle adjustments' CUDA-graph counters on a made-up
run: replays over captures plus replays, summed over the window's maps,
and no reading where the program has no such counter."""

from sfmbench import core

READER = {r.name: r for r in core.load_readers()}["ba.graph_replay_share"]


def _run(counters, maps=2):
    return core.Run(maps=[core.MapRecord(wall_s=9.0, offered=30, registered=30,
                                         counters=dict(counters), timings={}, stats={})
                          for _ in range(maps)], spans=core.Spans())


def test_reader_reads_replays_over_all_stretch_runs():
    counters = {"ba_iters": 40, "ba_graph_captures": 12, "ba_graph_replays": 36}
    assert READER.read(_run(counters)) == 72 / 96
    assert READER.read(_run({"ba_iters": 40, "ba_graph_captures": 5})) == 0.0
    assert READER.drivers == ("chained", "pipeline") and READER.moves == "frames_per_s"
    assert (READER.unit, READER.better, READER.source) == ("share", "higher", "program_counter")
    # A program without the counters (the parent of this reader) gives no
    # reading, and no error.
    assert READER.read(_run({"ba_iters": 40, "ba_selfcal_iters": 10})) is None
    assert READER.read(_run({}, maps=0)) is None
